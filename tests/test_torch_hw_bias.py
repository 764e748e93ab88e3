"""The hourly panel's generating parameters against the estimator's bias.

The additive Holt-Winters fit seeds its level, trend and seasonal ring from
each series' first two valid days, and those seeds carry about one noise
unit of error per seasonal slot, which pulls the estimated gamma upward.
Here the JAX package's scan fit (the reference estimator) and the port's
eager fit run on the same slice of ``entry``'s hourly panel, drawn at two
parameter sets: at (0.3, 0.01, 0.2) the reference's median gamma lands more
than 0.05 high, at ``entry.HW_PARAMS`` = (0.2, 0.01, 0.3) within 0.05, and
at both the port reads what the reference reads.  So the bias is the
estimator's, not the port's.  ``pytest -s`` prints the readings.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from spark_timeseries_tpu.models import holtwinters as jhw
from spark_timeseries_tpu_torch import entry as tentry
from spark_timeseries_tpu_torch.models import holtwinters as thw

ROWS, TIME = 256, 960


@pytest.mark.parametrize("params,gamma_biased", [
    ((0.3, 0.01, 0.2), True), (tentry.HW_PARAMS, False)])
def test_gamma_bias_is_the_reference_estimators(params, gamma_biased):
    y = tentry._hourly_panel(ROWS, TIME, params, 0, "cpu")
    ref = jhw.fit(jnp.asarray(y.numpy()), tentry.HW_PERIOD, "additive",
                  backend="scan")
    got = thw.fit(y, tentry.HW_PERIOD, "additive", device="cpu")
    med_ref = np.nanmedian(np.asarray(ref.params), axis=0)
    med_got = got.params.nanmedian(dim=0).values.numpy()
    print(f"\n  generating {params}: median [alpha, beta, gamma] reference "
          f"(JAX scan) {med_ref.tolist()}, port (eager) {med_got.tolist()}; "
          f"converged {float(np.asarray(ref.converged).mean()):.4f} / "
          f"{float(got.converged.float().mean()):.4f}")
    assert np.asarray(ref.converged).mean() > 0.9
    assert float(got.converged.float().mean()) > 0.9
    np.testing.assert_allclose(med_got, med_ref, atol=5e-3)
    assert abs(med_ref[0] - params[0]) < 0.05
    assert (med_ref[2] - params[2] > 0.05) == gamma_biased
