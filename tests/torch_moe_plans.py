"""Hooks on both packages' MoE dispatch plans, for the port's parity tests."""
import contextlib
from unittest import mock

import numpy as np
import torch

from repro.models import moe as jmoe
from repro_torch.models import moe


@contextlib.contextmanager
def moe_plans(replay=False):
    """Every ``moe_dispatch_plan`` call of either package, recorded in
    order: yields a list that receives ``(reference's plan, port's plan)``,
    one pair per MoE layer call, when the block ends. With ``replay`` the
    port's n-th call returns the reference's n-th plan instead of its own,
    so that both route alike; the reference then runs first. Either way
    both run their periods unrolled (``scan_periods=False``), so that the
    calls pair up."""
    jplans, tplans, pairs = [], [], []
    jreal, treal = jmoe.moe_dispatch_plan, moe.moe_dispatch_plan

    def jrecord(*a):
        jplans.append(jreal(*a))
        return jplans[-1]

    def trecord(*a):
        if replay:
            plan = moe.DispatchPlan(*(torch.from_numpy(np.array(x))
                                      for x in jplans[len(tplans)]))
        else:
            plan = treal(*a)
        tplans.append(plan)
        return plan

    with mock.patch.object(jmoe, "moe_dispatch_plan", jrecord), \
            mock.patch.object(moe, "moe_dispatch_plan", trecord):
        yield pairs
    assert len(jplans) == len(tplans), (len(jplans), len(tplans))
    pairs.extend(zip(jplans, tplans))
