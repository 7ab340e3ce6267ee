"""Shared layers of the port (counterpart of ``repro/models/layers.py``).

Parameters live in small ``nn.Module``s whose attribute names follow the
reference's parameter tree (``norm1.scale``, ``attn.wq``, ``mlp.up.w``...),
so ``checkpoint/bridge.py`` maps keys one for one.  Initialisers draw the
reference's distributions from an explicit ``torch.Generator``: normal x
``d_in ** -0.5`` for dense weights, std 1.0 for the embedding (vocab padded
to a multiple of 256), zeros for norm scales.  Parameters are built with
``requires_grad=False`` (serving); training turns it on
(``launch/train.py``).

Tensor-parallel ranks (``Model(group=...)``, the mesh's ``model`` axis): a
parameter may hold only its rank's block of the global tensor
(``block_of``); ``normal_`` then draws the global tensor, as one rank
would, and keeps the block, so the ranks' blocks put together are the
one-rank weights bit for bit.  A module whose weight is cut over the ranks
names their group in ``tp`` (None otherwise): the MLP's ``down`` partial
products are summed over it, the embedding's vocab blocks looked up by
block and summed, and the logits' vocab blocks gathered
(``launch.dist``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.launch.dist import all_gather_cat, all_reduce_sum

VOCAB_PAD = 256


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


def block_of(p: torch.Tensor):
    """(global shape, index of ``p``'s block in it): a rank's block of a
    tensor-parallel parameter (``Model(group=...)``), or ``p``'s own shape
    and the whole of it."""

    return getattr(p, "tp_block", (tuple(p.shape), (slice(None),) * p.dim()))


def global_shape(p: torch.Tensor):
    return block_of(p)[0]


def normal_(p: torch.Tensor, std: float, generator: torch.Generator, block=None) -> None:
    """Fill ``p`` with N(0, std^2) drawn in float32, then cast (as
    ``_normal``); a rank's block draws the global tensor and keeps its
    block (``block``: the (global shape, index) that ``p`` holds, for a
    view such as one expert of a stacked weight; default ``block_of(p)``).
    An index entry is a slice, or a list of positions where a dim holds
    its block of each of several parts (Mamba's fused ``in_proj``)."""

    shape, index = block or block_of(p)
    draw = torch.randn(shape, generator=generator, device=p.device, dtype=torch.float32)
    p.copy_(draw[index].mul_(std))


class Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int, dtype, device):
        super().__init__()
        self.w = _param((d_in, d_out), dtype, device)
        self.tp = None

    def init(self, generator: torch.Generator) -> None:
        normal_(self.w, global_shape(self.w)[0] ** -0.5, generator)


class Norm(nn.Module):
    def __init__(self, d: int, dtype, device):
        super().__init__()
        self.scale = _param((d,), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        self.scale.zero_()


class Embedding(nn.Module):
    def __init__(self, vocab: int, d: int, dtype, device, pad_to: int = VOCAB_PAD):
        super().__init__()
        vpad = -(-vocab // pad_to) * pad_to
        self.table = _param((vpad, d), dtype, device)
        self.tp = None

    def init(self, generator: torch.Generator) -> None:
        normal_(self.table, 1.0, generator)


class MLP(nn.Module):
    """Gated, ``down(act(gate(x)) * up(x))`` (SwiGLU, GeGLU), or plain,
    ``down(act(up(x)))``, which has no ``gate`` (as ``init_mlp``)."""

    def __init__(self, d_model: int, d_ff: int, dtype, device, gated: bool = True):
        super().__init__()
        self.up = Dense(d_model, d_ff, dtype, device)
        if gated:
            self.gate = Dense(d_model, d_ff, dtype, device)
        self.down = Dense(d_ff, d_model, dtype, device)
        self.tp = None

    def init(self, generator: torch.Generator) -> None:
        for m in self.children():
            m.init(generator)


# ---------------------------------------------------------------------------
# forward ops
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    # parity: float32 math and gemma-style (1 + scale), zeros-init scale ==
    # identity at init (repro/models/layers.py:85-91)
    dtype = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dtype)


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return x @ w.to(x.dtype)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    return cap * torch.tanh(x / cap) if cap else x


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # parity: jax.nn.gelu(approximate=True), the tanh form, for both "gelu"
    # and "gelu_plain" (repro/models/layers.py:104-108)
    return F.gelu(x, approximate="tanh")


ACTIVATIONS = {"silu": F.silu, "gelu": _gelu, "gelu_plain": _gelu}


def mlp(x: torch.Tensor, m: MLP, activation: str = "silu") -> torch.Tensor:
    """The MLP; on a rank of ``m.tp`` over its ``d_ff`` columns, the
    ``down`` partial products summed over the ranks."""

    act = ACTIVATIONS[activation]
    h = dense(x, m.up.w)
    h = act(dense(x, m.gate.w)) * h if hasattr(m, "gate") else act(h)
    return all_reduce_sum(dense(h, m.down.w), m.tp)


def embed_scale(d_model: int) -> float:
    """sqrt(d_model) rounded to bf16, the factor the reference applies:
    ``jnp.asarray(d_model**0.5, bf16)`` (59.866 -> 59.75 at 3584, 55.426 ->
    55.5 at 3072)."""

    return float(torch.tensor(d_model**0.5, dtype=torch.bfloat16))


def embed_lookup(tokens: torch.Tensor, table: torch.Tensor, scale: float = 0.0,
                 tp=None) -> torch.Tensor:
    """Rows of ``table`` in bf16, times ``scale`` in bf16 when it is set.

    Parity: the reference casts the table to bf16 even in f32 stacks and
    scales in bf16 (repro/models/layers.py:132-136), so the gradient of a
    row that occurs several times is summed in bf16 too; a bf16 product of
    two bf16 values is the exact product rounded once, as a float32
    product rounded to bf16 is.  (A bf16 table is not copied.)

    ``tp``: ``table`` is rank ``tp.rank``'s block of the vocab rows; an id
    outside it gives a zero row, and the rows are summed over the ranks.
    One rank holds each id, so the sum adds zeros to one row, exactly."""

    if tp is None:
        x = table.to(torch.bfloat16)[tokens]
        return x * scale if scale else x
    n = table.shape[0]
    local = tokens - tp.rank * n
    mine = (local >= 0) & (local < n)
    x = table.to(torch.bfloat16)[torch.where(mine, local, torch.zeros_like(local))]
    x = torch.where(mine[..., None], x, torch.zeros_like(x))
    return all_reduce_sum(x * scale if scale else x, tp)


def logits_from_embedding(x: torch.Tensor, table: torch.Tensor, vocab_size: int,
                          cap: float = 0.0, tp=None) -> torch.Tensor:
    """Tied-head logits x . table^T, then ``mask_padded_vocab``; with
    ``tp``, ``table``'s vocab block's logits gathered over the ranks
    first."""

    return mask_padded_vocab(all_gather_cat(x @ table.to(x.dtype).T, -1, tp), vocab_size, cap)


def mask_padded_vocab(logits: torch.Tensor, vocab_size: int, cap: float = 0.0) -> torch.Tensor:
    """The softcap, then -1e9 on ids >= ``vocab_size`` of a padded head
    (repro/models/layers.py:139-150)."""

    logits = softcap(logits, cap)
    if logits.shape[-1] != vocab_size:
        pad = torch.arange(logits.shape[-1], device=logits.device) >= vocab_size
        logits = logits.masked_fill(pad, -1e9)
    return logits


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean next-token cross entropy in float32; logits [..., V], labels
    int [...]; with ``mask``, the mean over its weights (at least 1)."""

    logits = logits.float()
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    nll = torch.logsumexp(logits, dim=-1) - gold
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def sinusoidal_positions(seq: int, d: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """Sinusoidal position encoding [seq, d] (sines, then cosines), in
    float32 and then cast, as the reference's (layers.py:152-159): its
    ``log(10000) / (d / 2)`` is a float32 log divided in float32."""

    f32 = dict(dtype=torch.float32, device=device)
    half = d // 2
    pos = torch.arange(seq, **f32)[:, None]
    # the log of a filled tensor: no host-to-device copy (a CUDA graph may
    # be capturing)
    freq = torch.exp(-torch.arange(half, **f32) * (torch.log(torch.full((), 10000.0, **f32)) / half))
    ang = pos * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).to(dtype)
