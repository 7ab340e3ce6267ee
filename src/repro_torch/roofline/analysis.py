"""Three-term roofline of a workload on a card (counterpart of
``repro/roofline/analysis.py``):

    compute term    = FLOPs / (devices x peak FLOP/s)
    memory term     = HBM bytes / (devices x HBM bytes/s)
    collective term = collective bytes / (devices x link bytes/s)

The FLOPs and bytes are the analytic counts of ``roofline/costmodel.py``
(``estimate``).  The reference reads its collective bytes from the HLO that
GSPMD compiled; the port compiles no HLO, and its dry run passes the result
bytes of the collectives one rank of the mesh's ``model`` axis issues, as
counted from the layer kinds (``launch.dist.collective_bytes``: every
collective of a rank is an explicit ``torch.distributed`` call).  The term
is modeled from those counts, not measured, and divided as the reference
divides it.  GSPMD may place collectives the port's ranks do not run (its
``act_seq`` / ``kv_seq`` rules), so the two are not the same quantity.
``collective_bytes=None`` (a stack the model axis refuses, or training)
leaves the term None.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class HwSpec:
    name: str
    peak_flops: float  # bf16 dense, FLOP/s
    hbm_bw: float      # bytes/s
    ici_bw: float      # bytes/s a link, one direction


# NVIDIA H100 SXM, as ``nvidia-smi`` names the card this repo runs on:
# "NVIDIA H100 80GB HBM3", power limit 700.00 W.  Data-sheet peaks at that
# limit: 989e12 bf16 dense FLOP/s on the tensor cores, 3.35e12 HBM bytes/s,
# and NVLink 4's 450e9 bytes/s a direction a GPU.  A card set below 700 W
# runs slower under load.
HW_H100 = HwSpec(name="nvidia_h100_sxm", peak_flops=989e12, hbm_bw=3.35e12, ici_bw=450e9)


@dataclass
class RooflineTerms:
    """The reference's fields.  ``hlo_gflops`` / ``hlo_gbytes`` keep the
    reference's names for the counts the terms divide (here the cost
    model's, whole program, all devices); ``collective_gbytes`` and
    ``collective_s`` are None where no collective was counted."""

    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_gflops: float
    hlo_gbytes: float
    collective_gbytes: Optional[float]
    compute_s: float
    memory_s: float
    collective_s: Optional[float]
    model_gflops: float  # useful FLOPs (6 N D train, 2 N D infer)
    useful_ratio: float
    bottleneck: str
    mem_per_device_gb: float

    def as_dict(self) -> dict:
        return dict(self.__dict__)


def roofline_from_compiled(
    *,
    arch: str,
    shape: str,
    mesh_name: str,
    chips: int,
    flops: float,
    bytes_accessed: float,
    collective_bytes: Optional[float],
    model_flops: float,
    mem_per_device_bytes: float,
    hw: HwSpec = HW_H100,
) -> RooflineTerms:
    """The three terms over ``chips`` devices of ``hw``, under the
    reference's name; nothing is compiled here.  ``collective_bytes=None``
    leaves the collective term None, and the bottleneck is then the larger
    of compute and memory."""

    compute_s = flops / (chips * hw.peak_flops)
    memory_s = bytes_accessed / (chips * hw.hbm_bw)
    terms = {"compute": compute_s, "memory": memory_s}
    collective_s = None
    if collective_bytes is not None:
        collective_s = collective_bytes / (chips * hw.ici_bw)
        terms["collective"] = collective_s
    return RooflineTerms(
        arch=arch,
        shape=shape,
        mesh=mesh_name,
        chips=chips,
        hlo_gflops=flops / 1e9,
        hlo_gbytes=bytes_accessed / 1e9,
        collective_gbytes=None if collective_bytes is None else collective_bytes / 1e9,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        model_gflops=model_flops / 1e9,
        useful_ratio=model_flops / flops if flops else 0.0,
        bottleneck=max(terms, key=terms.get),
        mem_per_device_gb=mem_per_device_bytes / 1e9,
    )
