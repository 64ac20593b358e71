"""Per-stage timing and numerical-safety checks."""

from meshrecon_torch.utils.profiling import (StageTimer, stage_report,
                                             profile_trace)
from meshrecon_torch.utils.debug import enable_nan_checks, checked

__all__ = ["StageTimer", "stage_report", "profile_trace", "enable_nan_checks",
           "checked"]
