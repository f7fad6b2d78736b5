"""Plain fp32 PyTorch reference of a training step: the pieces every block
kind shares (RMSNorm, rotary embedding, causal GQA attention, the loss
with z-loss, AdamW) and the step itself, layer by layer.

It imports nothing of the port.  It computes in fp32 with TF32 off
(:func:`strict_fp32`).  The products' operands pass through a
:class:`Precision`: fp32 as it is, or, for the control that the check
must refuse, rounded to fp8 (e4m3, scaled per tensor by its largest
magnitude), the next precision below the bf16 that the configurations
state for their products.  Gradients pass the rounding unchanged.

Memory: the forward keeps only each layer's input; the backward runs one
layer at a time again under autograd.  Attention is computed in blocks
of queries, its backward from the saved log-sum-exp.  The head and loss
run in blocks of tokens.
"""
from __future__ import annotations

import math

import torch

from perfbench import weights

#: queries a block of the attention; tokens a block of the head and loss
QUERY_BLOCK = 512
TOKEN_BLOCK = 4096
Z_LOSS = 1e-4


def strict_fp32() -> None:
    """fp32 products in fp32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """The rounding of a product's operands: none (``"fp32"``) or fp8
    e4m3 scaled per tensor (``"fp8"``), with the gradient passed
    straight through."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def value(self, x: torch.Tensor) -> torch.Tensor:
        """The rounded values, without a gradient."""
        if self.kind == "fp32":
            return x
        x = x.detach()
        scale = 448.0 / torch.clamp(x.abs().amax(), min=1e-30)
        return (x * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return x
        return x + (self.value(x) - x.detach())


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """x / rms(x) * (1 + scale): the port's norm, whose scale starts at 0."""
    return x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps) \
        * (1.0 + scale)


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of x [B, T, H, dh] at positions 0..T-1, the two
    halves of each head rotated together."""
    t, dh = x.shape[1], x.shape[-1]
    half = dh // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32,
                                   device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] * freq
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _expand(x: torch.Tensor, heads: int) -> torch.Tensor:
    """[B, T, KH, dh] -> [B, H, T, dh]: query head h reads kv head
    h // (H / KH)."""
    return x.repeat_interleave(heads // x.shape[2], dim=2).transpose(1, 2)


def _scores(q, k, i0, i1, scale):
    """Scaled scores of queries i0..i1 against keys 0..i1, the later keys
    masked."""
    s = torch.matmul(q[:, :, i0:i1], k[:, :, :i1].transpose(-1, -2)) * scale
    rows = torch.arange(i0, i1, device=q.device)[:, None]
    cols = torch.arange(i1, device=q.device)[None, :]
    return s.masked_fill(cols > rows, -math.inf)


class CausalAttention(torch.autograd.Function):
    """softmax(q k^T / sqrt(dh), causal) v for q [B, T, H, dh] and k, v
    [B, T, KH, dh], in blocks of :data:`QUERY_BLOCK` queries; the
    backward recomputes each block's probabilities from the saved
    log-sum-exp."""

    @staticmethod
    def forward(ctx, q, k, v, prec):
        b, t, h, dh = q.shape
        qh = q.transpose(1, 2)
        kh, vh = _expand(k, h), _expand(v, h)
        qr, kr, vr = prec.value(qh), prec.value(kh), prec.value(vh)
        scale = 1.0 / math.sqrt(dh)
        out = torch.empty_like(qh)
        lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
        for i0 in range(0, t, QUERY_BLOCK):
            i1 = min(i0 + QUERY_BLOCK, t)
            s = _scores(qr, kr, i0, i1, scale)
            lse[:, :, i0:i1] = torch.logsumexp(s, dim=-1)
            p = torch.exp(s - lse[:, :, i0:i1, None])
            out[:, :, i0:i1] = torch.matmul(prec.value(p), vr[:, :, :i1])
        ctx.save_for_backward(qh, kh, vh, out, lse)
        ctx.kv_heads = k.shape[2]
        return out.transpose(1, 2)

    @staticmethod
    def backward(ctx, dout):
        qh, kh, vh, out, lse = ctx.saved_tensors
        b, h, t, dh = qh.shape
        do = dout.transpose(1, 2)
        scale = 1.0 / math.sqrt(dh)
        delta = torch.sum(do * out, dim=-1)
        dq = torch.empty_like(qh)
        dk, dv = torch.zeros_like(kh), torch.zeros_like(vh)
        for i0 in range(0, t, QUERY_BLOCK):
            i1 = min(i0 + QUERY_BLOCK, t)
            p = torch.exp(_scores(qh, kh, i0, i1, scale)
                          - lse[:, :, i0:i1, None])
            dob = do[:, :, i0:i1]
            dv[:, :, :i1] += torch.matmul(p.transpose(-1, -2), dob)
            dp = torch.matmul(dob, vh[:, :, :i1].transpose(-1, -2))
            ds = p * (dp - delta[:, :, i0:i1, None]) * scale
            dq[:, :, i0:i1] = torch.matmul(ds, kh[:, :, :i1])
            dk[:, :, :i1] += torch.matmul(ds.transpose(-1, -2),
                                          qh[:, :, i0:i1])
        kv = ctx.kv_heads

        def fold(g):            # [B, H, T, dh] -> [B, T, KH, dh]
            return g.reshape(b, kv, h // kv, t, dh).sum(2).transpose(1, 2)
        return dq.transpose(1, 2), fold(dk), fold(dv), None


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


# ---------------------------------------------------------------------- #
# the step
# ---------------------------------------------------------------------- #
def _head_loss(params: dict, cfg: dict, x: torch.Tensor, labels: torch.Tensor,
               prec: Precision) -> float:
    """Next-token cross-entropy plus z-loss, both means over the tokens,
    of the final norm and head over x [B, T, D]; accumulates the
    gradients of the head, the final norm and ``x`` in blocks of
    tokens.  Returns the loss."""
    lab = labels.reshape(-1).long()
    n = lab.numel()
    total = 0.0
    for i0 in range(0, n, TOKEN_BLOCK):
        xb = x.reshape(n, x.shape[-1])[i0:i0 + TOKEN_BLOCK]
        h = rmsnorm(xb, params["ln_final.scale"], cfg["norm_eps"])
        logits = torch.matmul(prec(h), prec(params["lm_head"]))
        lse = torch.logsumexp(logits, dim=-1)
        ll = torch.gather(logits, 1, lab[i0:i0 + TOKEN_BLOCK, None])[:, 0]
        part = (torch.sum(lse - ll) + Z_LOSS * torch.sum(lse * lse)) / n
        part.backward()
        total += float(part.detach())
    return total


def loss_and_grads(params: dict, cfg: dict, batch: dict, prec: Precision
                   ) -> float:
    """The loss of ``batch`` (``tokens``, ``labels`` [B, T]) and, in each
    parameter's ``.grad``, its gradient."""
    kinds = weights.layer_kinds(cfg)
    layer = lambda i: {k.split(".", 3)[3]: v for k, v in params.items()
                       if k.startswith(f"stack.layers.{i}.")}
    with torch.no_grad():
        xs = [params["embed"][batch["tokens"].long()]]
        for i, kind in enumerate(kinds):
            xs.append(weights.block(kind).apply(layer(i), xs[-1], cfg, prec))
    top = xs[-1].requires_grad_()
    loss = _head_loss(params, cfg, top, batch["labels"], prec)
    grad = top.grad
    for i in reversed(range(len(kinds))):
        x = xs[i].requires_grad_()
        out = weights.block(kinds[i]).apply(layer(i), x, cfg, prec)
        out.backward(grad)
        grad = x.grad
        xs[i + 1] = None
    emb = params["embed"]
    if emb.grad is None:
        emb.grad = torch.zeros_like(emb)
    emb.grad.index_add_(0, batch["tokens"].reshape(-1).long(),
                        grad.reshape(-1, grad.shape[-1]))
    return loss


def lr_at(step: int, opt: dict) -> float:
    """Linear warm-up, then cosine to a tenth of the peak (``step`` from
    1)."""
    peak, warm, total = opt["peak_lr"], opt["warmup_steps"], opt["total_steps"]
    if step < warm:
        return peak * step / max(1.0, warm)
    prog = min(max((step - warm) / max(1.0, total - warm), 0.0), 1.0)
    return peak * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * prog)))


@torch.no_grad()
def adamw(params: dict, state: dict, opt: dict, decayed) -> list[float]:
    """One AdamW step on every parameter's ``.grad`` (then cleared):
    clip by the global norm, bias-corrected moments, decoupled decay on
    the leaves ``decayed(name)`` names.  Returns each leaf's clipped
    gradient norm."""
    step = state["step"] = state.get("step", 0) + 1
    names = list(params)
    norms = torch.stack([torch.linalg.vector_norm(params[k].grad)
                         for k in names])
    scale = min(1.0, opt["grad_clip"] / max(float(torch.linalg.vector_norm(
        norms)), 1e-12))
    lr = lr_at(step, opt)
    b1, b2 = opt["b1"], opt["b2"]
    for k in names:
        p = params[k]
        g = p.grad * scale
        m = state.setdefault(("m", k), torch.zeros_like(p))
        v = state.setdefault(("v", k), torch.zeros_like(p))
        m.mul_(b1).add_(g, alpha=1 - b1)
        v.mul_(b2).addcmul_(g, g, value=1 - b2)
        upd = (m / (1 - b1 ** step)) / (torch.sqrt(v / (1 - b2 ** step))
                                        + opt["eps"])
        if decayed(k):
            upd.add_(p, alpha=opt["weight_decay"])
        p.sub_(lr * upd)
        p.grad = None
    return (norms * scale).tolist()


def decayed(name: str, ndim: int) -> bool:
    """AdamW's decay rule as the configurations state it: every leaf of
    two or more dims, and every leaf of a layer (the layers are stacked
    [L, ...] in the model's definition, so their vectors have two
    dims); the final norm is not decayed."""
    return ndim >= 2 or name.startswith("stack.layers.")


def train_steps(cfg: dict, opt: dict, batches: list[dict], seed: int,
                device, prec: Precision) -> dict:
    """The reference's first ``len(batches)`` training steps from the
    benchmark's initial weights for ``seed``: each step's loss, each
    leaf's clipped gradient norm at step 1, and each leaf's change norm
    after the last step (the leaves in ``weights.layout`` order)."""
    strict_fp32()
    leaves = weights.layout(cfg)
    params = {leaf.name: v.requires_grad_() for leaf, v in
              zip(leaves, weights.make(leaves, seed, device))}
    ndims = {leaf.name: len(leaf.shape) for leaf in leaves}
    state: dict = {}
    losses, first = [], None
    for batch in batches:
        batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        losses.append(loss_and_grads(params, cfg, batch, prec))
        norms = adamw(params, state, opt, lambda k: decayed(k, ndims[k]))
        first = first or norms
    change = weights.change_norms(leaves, [params[leaf.name]
                                           for leaf in leaves], seed)
    return {"loss": losses, "first_grad": first, "change": change}
