"""Port parity: three train steps of every family that
``test_torch_train.py`` does not hold, against the reference, on the CPU.

The reduced dbrx-132b, deepseek-v2-236b, jamba-v0.1-52b, mamba2-780m,
seamless-m4t-medium (stub ``frames``) and phi-3-vision-4.2b (stub
``prefix_embeds``) in fp32 compute: three ``train_step``s from one
``train_state_from_jax`` state, each on a fresh seeded batch, hold every
metric within 1e-5 relative, both AdamW moments within 1e-4 of their
largest entry and the parameters within that plus 5 % of one step (lr),
the bounds of ``test_torch_train.py``'s step test. The MoE archs'
gradients go through the gather's and the combine's backwards.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro import optim as joptim  # noqa: E402
from repro.models import init_params as jinit  # noqa: E402
from repro.train import TrainConfig as JTrainConfig  # noqa: E402
from repro.train import init_state as jinit_state  # noqa: E402
from repro.train import train_step as jtrain_step  # noqa: E402
from repro_torch import optim  # noqa: E402
from repro_torch.models import train_state_from_jax  # noqa: E402
from repro_torch.train import TrainConfig, make_train_step  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402
from test_torch_train import (  # noqa: E402
    _configs,
    _jax_batch,
    _port_tree,
    _torch_batch,
)
from test_torch_train_families import ARCHS, _family_batch  # noqa: E402


@pytest.mark.parametrize("arch", ARCHS)
def test_family_three_train_steps_match_reference(arch):
    jc, tc = _configs(arch, "float32")
    ocfg = dict(lr=1e-3, warmup_steps=2, total_steps=6, schedule="cosine",
                weight_decay=0.1, grad_clip=1.0)
    jt = JTrainConfig(optimizer=joptim.AdamWConfig(**ocfg))
    tt = TrainConfig(optimizer=optim.AdamWConfig(**ocfg))
    jstate = jinit_state(jinit(jax.random.PRNGKey(0), jc), jt)
    state = train_state_from_jax(jax.tree.map(np.asarray, jstate), tc, "cpu")
    step = make_train_step(tc, tt)
    for i in range(3):
        nb = _family_batch(tc, 10 + i)
        jstate, jm = jtrain_step(jstate, _jax_batch(nb), jc, jt)
        state, m = step(state, _torch_batch(nb))
        assert set(m) == set(jm)
        for k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    assert int(state.opt.step) == int(jstate.opt.step) == 3
    for name, mine, ref in (("params", state.params, jstate.params),
                            ("m", state.opt.m, jstate.opt.m),
                            ("v", state.opt.v, jstate.opt.v)):
        want, got = _port_tree(ref, tc), flatten(mine)
        # As in test_torch_train.py: a gradient of pure rounding noise (a
        # key bias's) moves its parameter by up to lr in either package.
        slack = 0.05 * ocfg["lr"] if name == "params" else 1e-12
        for k, w in want.items():
            err = float((got[k] - w).abs().max())
            assert err <= 1e-4 * float(w.abs().max()) + slack, (name, k, err)
