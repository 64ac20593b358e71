"""meshrecon_torch.utils: the NaN checks of utils/debug.py (a
TorchDispatchMode where the JAX package uses jax_debug_nans and checkify)
and stage_report, against meshrecon.utils on the CPU.

``checked(fn)`` returns ``(err, out)`` as the JAX package's does
(tests/test_pipeline.py's case: sqrt(4) gives no error and 2.0); a NaN
names its aten operation; ``enable_nan_checks(True)`` raises
FloatingPointError at the first NaN and ``False`` restores the plain
behaviour.
"""

import numpy as np
import pytest
import torch

from meshrecon_torch import utils
from meshrecon_torch.utils import debug
from meshrecon_torch.utils.profiling import StageTimer


def test_checked_sqrt_matches_jax():
    import jax.numpy as jnp

    from meshrecon.utils.debug import checked as j_checked

    j_err, j_out = j_checked(lambda x: jnp.sqrt(x))(jnp.asarray(4.0))
    err, out = utils.checked(torch.sqrt)(torch.tensor(4.0))
    assert err is None and float(out) == float(j_out) == 2.0
    j_err.throw()  # no error on the JAX side either


def test_checked_names_the_first_nan_op():
    def fn(x):
        y = torch.sqrt(x)  # NaN at -1
        return torch.exp(y) + 1.0

    err, out = utils.checked(fn)(torch.tensor([4.0, -1.0]))
    assert "aten.sqrt" in err
    assert torch.isnan(out[1]) and out[0] == pytest.approx(np.exp(2.0) + 1.0)


def test_checked_rejects_unknown_checks():
    with pytest.raises(ValueError, match="only the 'nan' check"):
        utils.checked(torch.sqrt, errors={"oob"})
    err, _ = utils.checked(torch.sqrt, errors={"nan"})(torch.tensor(-1.0))
    assert "aten.sqrt" in err


def test_enable_nan_checks_raises_then_restores():
    try:
        utils.enable_nan_checks(True)
        utils.enable_nan_checks(True)  # idempotent: one mode installed
        assert torch.sqrt(torch.tensor(4.0)) == 2.0
        with pytest.raises(FloatingPointError, match="aten.sqrt"):
            torch.sqrt(torch.tensor(-1.0))
        with pytest.raises(FloatingPointError, match="aten.log"):
            torch.log(torch.tensor(-1.0))  # the next NaN raises too
    finally:
        utils.enable_nan_checks(False)
    assert not debug._ENABLED
    assert torch.isnan(torch.sqrt(torch.tensor(-1.0)))


def test_stage_report_matches_jax():
    from meshrecon.utils import stage_report as j_stage_report
    from meshrecon.utils.profiling import StageTimer as JStageTimer

    ours, ref = StageTimer(), JStageTimer()
    for t in (ours, ref):
        t.times["a"], t.counts["a"], t.pixels["a"] = 2.0, 3, 4_000_000
        t.times["b"], t.counts["b"] = 0.5, 1
    assert utils.stage_report(ours) == j_stage_report(ref)


def test_utils_exports():
    assert set(utils.__all__) == {"StageTimer", "stage_report",
                                  "enable_nan_checks", "checked"}
