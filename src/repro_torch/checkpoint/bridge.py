"""Load reference-layout weights into the port's ``Model``.

The input is a ``{key: np.ndarray}`` dict of the reference's parameter tree
flattened with ``/``-joined paths, bf16 widened to float32 — the layout of
``repro/checkpoint/npz.py`` ``_flatten`` (``embed/table``, ``mod_proj/w``,
``unit/<j>/attn/wq``, ``unit/<j>/mamba/in_proj``, ``unit/<j>/moe/up``,
``unit/<j>/mlp/up/w``, ``unit/<j>/mlstm/up_proj``, ``unit/<j>/xattn/wq``,
``enc_unit/0/attn/wq``, ``final_norm/scale``, ``enc_norm/scale``,
``lm_head/w``).  Block parameters are stacked over the repeats of the
reference's repeating unit of ``period`` layers
(``models.model.unit_period``), so port layer ``i`` reads
``unit/{i % period}/...[i // period]``: a stack of identical layers has
period 1, jamba-smoke (mamba, attn), gemma2 (local, global) and xLSTM
(mlstm, slstm) period 2.  An encoder's layers are a unit of one layer:
port encoder layer ``i`` reads ``enc_unit/0/...[i]``.  Float32 parameters
(router, ``dt_bias``, ``a_log``, ``d_skip``, ``if_bias``, the sLSTM
``bias``) stay float32.  The bridge walks the port's own parameters, so a key the port
lacks is never asked for: a tied stack (gemma) has no ``lm_head/w`` and a
plain MLP (starcoder2) no ``mlp/gate/w``, in either tree.  Nothing here
imports JAX.

A tensor-parallel rank's model (``Model(group=...)``) takes its block of
each flat array (``models.layers.block_of``; a fused parameter its block
of each of its parts: Mamba's ``in_proj`` and the mLSTM's ``up_proj`` of
x and z, the mLSTM's ``w_if`` / ``if_bias`` of the i and f gates, the
sLSTM's ``w_in`` / ``w_rec`` / ``bias`` of its four gates and its ``up``
of gate and val), so the ranks' models put together hold the reference's
weights; a data rank's MoE layers (``Model(data_group=...)``) take their
block of the ``[E, ...]`` expert arrays the same way.

``reference_tensors`` is the inverse: the port's parameters, or any
tensors keyed like them (gradients, AdamW moments), in the reference's flat
layout, block tensors stacked over the repeats (what the gradient twins
compare and ``checkpoint/npz.py`` saves).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.layers import block_of
from repro_torch.models.model import Model


def reference_key(name: str, period: int = 1) -> Tuple[str, int]:
    """Port parameter name -> (reference key, index into the repeat axis).

    ``layers.5.attn.wq`` -> (``unit/0/attn/wq``, 5) with period 1, and
    (``unit/1/attn/wq``, 2) with period 2; ``enc_layers.3.attn.wq`` ->
    (``enc_unit/0/attn/wq``, 3); top-level names map to their key with
    index -1 (no repeat axis).
    """

    parts = name.split(".")
    if parts[0] == "enc_layers":
        return "/".join(["enc_unit", "0"] + parts[2:]), int(parts[1])
    if parts[0] != "layers":
        return "/".join(parts), -1
    i = int(parts[1])
    return "/".join(["unit", str(i % period)] + parts[2:]), i // period


@torch.no_grad()
def load_reference_params(model: Model, flat: Dict[str, np.ndarray]) -> Model:
    """Copy every parameter of ``model`` from ``flat`` (numpy arrays or
    tensors; cast to the parameter's dtype and device; a rank's model its
    block of each).  Raises on a missing key or a shape mismatch; returns
    ``model``."""

    for name, p in model.named_parameters():
        key, idx = reference_key(name, model.period)
        if key not in flat:
            raise KeyError(f"reference weights lack {key!r} (for {name})")
        arr = flat[key]
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().to("cpu", torch.float32).numpy()
        arr = np.asarray(arr)
        if idx >= 0:
            arr = arr[idx]
        shape, index = block_of(p)
        if tuple(arr.shape) != shape:
            raise ValueError(f"{key}: shape {arr.shape} != port {shape}")
        arr = arr[index]
        p.copy_(torch.from_numpy(np.array(arr, dtype=np.float32)))
    return model


def reference_tensors(model: Model, tensors: Optional[Dict[str, torch.Tensor]] = None
                      ) -> Dict[str, torch.Tensor]:
    """``tensors`` keyed by the port's parameter names (default: the model's
    own parameters) -> ``{reference key: tensor}``: a block tensor of layer
    ``i`` goes to row ``i // period`` of ``unit/{i % period}/...``, stacked
    over the repeats (encoder layers: ``enc_unit/0/...``); top-level tensors
    keep their shape.  Dtype and device stay the inputs'.  Raises on a name
    the model does not have or a repeat left out."""

    names = [name for name, _ in model.named_parameters()]
    if tensors is None:
        tensors = dict(model.named_parameters())
    unknown = set(tensors) - set(names)
    if unknown:
        raise KeyError(f"not parameters of the model: {sorted(unknown)[:4]}")
    rows: Dict[str, Dict[int, torch.Tensor]] = defaultdict(dict)
    out: Dict[str, torch.Tensor] = {}
    for name in names:
        if name not in tensors:
            continue
        key, idx = reference_key(name, model.period)
        if idx < 0:
            out[key] = tensors[name].detach()
        else:
            rows[key][idx] = tensors[name].detach()
    for key, by_idx in rows.items():
        if sorted(by_idx) != list(range(len(by_idx))):
            raise KeyError(f"{key}: repeats {sorted(by_idx)} are not 0..n-1")
        out[key] = torch.stack([by_idx[i] for i in range(len(by_idx))])
    return out
