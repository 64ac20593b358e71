"""Per-stage timing and numerical-safety checks."""

from meshrecon_torch.utils.profiling import StageTimer, stage_report
from meshrecon_torch.utils.debug import enable_nan_checks, checked

__all__ = ["StageTimer", "stage_report", "enable_nan_checks", "checked"]
