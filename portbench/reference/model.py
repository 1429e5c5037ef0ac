"""The reference forward pass, loss and gradients: a decoder of attention
blocks (grouped-query attention with RoPE and an optional q/k/v bias) with
a gated MLP (Qwen2) or a mixture of routed experts (DBRX), in plain
PyTorch at float32.

Weights are read from ``P``, a dict from a leaf's path to its tensor, kept
in the configuration's parameter dtype (``stack/slots/0/<layer>/...``,
``embed/embedding``, ``final_norm/scale``: the benchmark's seeded
weights). Every product takes its weight as stored and widens it to fp32
where it is used, so no fp32 copy of a bf16 weight outlives its product;
a weight's gradient is summed in fp32 into ``G[path]`` by the product's
own backward, since autograd would round it to the leaf's dtype.

``prec="fp8"`` is the control: every product's operands go through
float8 e4m3 with a per-tensor scale (their largest magnitude to 448), in
the forward and the backward, as an fp8 path in the program would run
them.

Departures from the published models, where the program departs: the
norm is RMSNorm with ``(1 + scale)`` (DBRX has LayerNorm), no q/k/v clip
(DBRX clips at 8), and the loss adds a z-loss and the router's
load-balance and z losses (the program's training loss).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


def fp32_exact() -> None:
    """Products in true float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def quantize8(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded through float8 e4m3 under a per-tensor scale, in fp32."""
    s = FP8_MAX / t.detach().abs().amax().float().clamp_min(1e-30)
    return (t.float() * s).to(torch.float8_e4m3fn).float() / s


def low(t: torch.Tensor, prec: str) -> torch.Tensor:
    """An operand of a product at ``prec``: as it is in fp32; through fp8
    for the control, its gradient passing straight through."""
    if prec != "fp8":
        return t
    return t + (quantize8(t) - t).detach()


def _mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "fp8":
        return quantize8(a) @ quantize8(b)
    return a.float() @ b.float()


class _Linear(torch.autograd.Function):
    """``x @ w`` with ``w`` as stored; the backward sums ``x^T dy`` into the
    fp32 buffer ``g`` (if any) and returns only the input's gradient."""

    @staticmethod
    def forward(ctx, x, w, g, prec):
        ctx.save_for_backward(x, w)
        ctx.g, ctx.prec = g, prec
        return _mm(x, w, prec)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx = _mm(dy, w.t(), ctx.prec)
        if ctx.g is not None:
            ctx.g.add_(_mm(x.reshape(-1, x.shape[-1]).t(),
                           dy.reshape(-1, dy.shape[-1]), ctx.prec))
        return dx, None, None, None


class _Embed(torch.autograd.Function):
    """Rows of the table, widened to fp32; the backward adds each row's
    gradient into ``g``. ``anchor`` (a scalar that requires grad) makes
    autograd reach this backward, as no other input requires grad."""

    @staticmethod
    def forward(ctx, tokens, table, g, anchor):
        ctx.save_for_backward(tokens)
        ctx.g = g
        return table[tokens].float()

    @staticmethod
    def backward(ctx, dy):
        (tokens,) = ctx.saved_tensors
        if ctx.g is not None:
            ctx.g.index_add_(0, tokens.reshape(-1),
                             dy.reshape(-1, dy.shape[-1]))
        return None, None, None, None


def rms_norm(x, scale, eps: float):
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x, theta: float):
    """Rotary embedding of x (B, S, H, D) at positions 0..S-1, the halves
    split (not interleaved)."""
    s, d = x.shape[1], x.shape[-1]
    inv = 1.0 / torch.pow(torch.tensor(theta, device=x.device),
                          torch.arange(0, d, 2, device=x.device,
                                       dtype=torch.float32) / d)
    ang = torch.arange(s, device=x.device, dtype=torch.float32)[:, None] * inv
    cos, sin = ang.cos()[None, :, None, :], ang.sin()[None, :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def capacity(t: int, moe: dict) -> int:
    """Slots an expert takes for ``t`` tokens (padded to 8)."""
    c = int(t * moe["experts_per_token"] * moe["capacity_factor"]
            // moe["num_experts"])
    return max(8, (c + 7) // 8 * 8)


class Model:
    """The model of ``arch`` over the weights ``P``. With ``G`` (fp32
    buffers by path) its backward sums every weight's gradient there."""

    def __init__(self, arch: dict, P: Dict[str, torch.Tensor],
                 G: Optional[Dict[str, torch.Tensor]] = None,
                 prec: str = "fp32"):
        self.a, self.P, self.G, self.prec = arch, P, G, prec
        # Norm scales and biases: fp32 leaves, their gradients read after
        # the backward (``small_grads``).
        self.small = {}
        for k, v in P.items():
            if v.ndim == 1 or k.endswith(("/bq", "/bk", "/bv")):
                self.small[k] = v.detach().float().requires_grad_(
                    G is not None)

    def small_grads(self) -> None:
        """Add the small leaves' gradients into ``G`` and clear them."""
        for k, v in self.small.items():
            if v.grad is not None:
                self.G[k].add_(v.grad)
                v.grad = None

    def lin(self, x, key: str, w=None, g=None):
        """x @ the weight at ``key`` (or the view ``w`` of it, with ``g`` the
        same view of its gradient buffer), widened to fp32 in the product."""
        if w is None:
            w = self.P[key]
            g = None if self.G is None else self.G[key]
            if w.ndim == 3:               # (d, heads, e) or (heads, e, d)
                w = w.reshape(-1, w.shape[-1]) if key.endswith("/wo") \
                    else w.reshape(w.shape[0], -1)
                g = None if g is None else g.view(w.shape)
        return _Linear.apply(x, w, g, self.prec)

    def attention(self, x, pre: str):
        a = self.a
        b, s, _ = x.shape
        h, kv, d = a["num_heads"], a["num_kv_heads"], a["head_dim"]
        q = self.lin(x, pre + "wq").view(b, s, h, d)
        k = self.lin(x, pre + "wk").view(b, s, kv, d)
        v = self.lin(x, pre + "wv").view(b, s, kv, d)
        if a["qkv_bias"]:
            q = q + self.small[pre + "bq"]
            k = k + self.small[pre + "bk"]
            v = v + self.small[pre + "bv"]
        q, k = rope(q, a["rope_theta"]), rope(k, a["rope_theta"])
        g = h // kv
        k = k.repeat_interleave(g, dim=2)
        v = v.repeat_interleave(g, dim=2)
        scores = torch.einsum("bqhd,bkhd->bhqk", low(q, self.prec),
                              low(k, self.prec)) * d ** -0.5
        mask = torch.ones(s, s, dtype=torch.bool, device=x.device).tril()
        p = torch.softmax(scores.masked_fill(~mask, float("-inf")), dim=-1)
        out = torch.einsum("bhqk,bkhd->bqhd", low(p, self.prec),
                           low(v, self.prec))
        return self.lin(out.reshape(b, s, h * d), pre + "wo")

    def mlp(self, x, pre: str):
        return self.lin(F.silu(self.lin(x, pre + "w_gate"))
                        * self.lin(x, pre + "w_up"), pre + "w_down")

    def moe(self, x, pre: str):
        """Routed experts over the tokens of x (B, S, d): the softmax
        router in fp32, top-k with ties to the lower expert, the k weights
        renormalised; each expert's copies beyond its capacity (in token
        order) dropped; the kept copies' outputs summed by weight. Returns
        the output and the auxiliary loss."""
        m = self.a["moe"]
        b, s, dm = x.shape
        t, e, k = b * s, m["num_experts"], m["experts_per_token"]
        xt = x.reshape(t, dm)
        logits = self.lin(xt, pre + "router")
        probs = torch.softmax(logits, dim=-1)
        top = torch.sort(-probs.detach(), dim=-1, stable=True).indices[:, :k]
        topv = probs.gather(-1, top)
        if m["norm_topk"]:
            topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
        flat = top.reshape(-1)
        order = torch.sort(flat, stable=True).indices
        se = flat[order]
        start = torch.searchsorted(se, torch.arange(e, device=x.device))
        rank = torch.arange(t * k, device=x.device) - start[se]
        keep = torch.empty_like(flat, dtype=torch.bool)
        keep[order] = rank < capacity(t, m)
        weights = topv.reshape(-1)
        y = torch.zeros((t, dm), dtype=torch.float32, device=x.device)
        G = self.G
        for ex in range(e):
            copies = torch.nonzero((flat == ex) & keep).flatten()
            if copies.numel() == 0:
                continue
            tok = copies // k
            xe = xt[tok]
            ws = {n: self.P[pre + n][ex] for n in ("w_gate", "w_up", "w_down")}
            gs = {n: None if G is None else G[pre + n][ex] for n in ws}
            hid = F.silu(self.lin(xe, None, ws["w_gate"], gs["w_gate"])) \
                * self.lin(xe, None, ws["w_up"], gs["w_up"])
            ye = self.lin(hid, None, ws["w_down"], gs["w_down"])
            y = y.index_add(0, tok, ye * weights[copies, None])
        me = probs.mean(dim=0)
        ce = F.one_hot(top, e).float().sum(1).mean(dim=0) * e / k
        lb = (me * ce).sum() * e * m["aux_loss_weight"]
        z = torch.logsumexp(logits, dim=-1).square().mean()
        return y.view(b, s, dm), lb + m["router_z_weight"] * z

    def block(self, x, i: int):
        pre = f"stack/slots/0/{i}/"
        eps = self.a["norm_eps"]
        x = x + self.attention(rms_norm(x, self.small[pre + "norm1/scale"],
                                        eps), pre + "mixer/")
        h = rms_norm(x, self.small[pre + "norm2/scale"], eps)
        if self.a["moe"] is None:
            zero = torch.zeros((), device=x.device)
            return x + self.mlp(h, pre + "ffn/"), zero
        y, aux = self.moe(h, pre + "ffn/")
        return x + y, aux

    def logits(self, tokens):
        """Logits (B, S, V) fp32 of the token rows, and the summed aux loss.
        Under grad each block is recomputed in the backward."""
        emb = self.P["embed/embedding"]
        anchor = torch.zeros((), device=tokens.device,
                             requires_grad=self.G is not None)
        x = _Embed.apply(tokens, emb, None if self.G is None
                         else self.G["embed/embedding"], anchor)
        aux = torch.zeros((), device=x.device)
        for i in range(self.a["num_layers"]):
            if torch.is_grad_enabled():
                x, a = checkpoint(self.block, x, i, use_reentrant=False)
            else:
                x, a = self.block(x, i)
            aux = aux + a
        x = rms_norm(x, self.small["final_norm/scale"], self.a["norm_eps"])
        if "embed/unembed" in self.P:
            return self.lin(x, "embed/unembed"), aux
        g = None if self.G is None else self.G["embed/embedding"].t()
        return self.lin(x, None, emb.t(), g), aux

    def loss(self, tokens, labels):
        """The training loss of the rows: the token-mean cross entropy, the
        z-loss of the logits and the routers' auxiliary losses."""
        logits, aux = self.logits(tokens)
        lse = torch.logsumexp(logits, dim=-1)
        ll = logits.gather(-1, labels[..., None]).squeeze(-1)
        return (lse - ll).mean() + self.a["z_loss_weight"] \
            * lse.square().mean() + aux
