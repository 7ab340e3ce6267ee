from repro_torch.roofline.analysis import (
    HW_H100,
    HwSpec,
    RooflineTerms,
    roofline_from_compiled,
)

__all__ = ["HW_H100", "HwSpec", "RooflineTerms", "roofline_from_compiled"]
