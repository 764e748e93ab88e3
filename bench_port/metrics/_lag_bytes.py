"""The least the CSS lag route's launches must move, from the program's
``work.css_lag_*`` counters (``ops.cuda_kernels``): each ``[T, B]`` panel
a launch reads or writes counted once, rows x steps a panel, then the
floats it reads or writes once a row and the coefficient and gradient
rows, 4 bytes each (float32), over the H100's 3.35 TB/s.

Panels by kind: a forward reads y in every mode and writes e in ``e`` and
``both``; the adjoint (``bwd``, which moves nothing of its own) reads y
where AR lags are listed (``bwd_y``), e where MA lags are listed or the
cotangent is a row's (``bwd_e``), a panel cotangent (``bwd_g``) and writes
the data cotangent (``bwd_gy``).
"""

WORD = 4
HBM_BYTES_PER_S = 3.35e12
PREFIX = "work.css_lag_row_steps."
PANELS = {"sum": 1, "both": 2, "e": 2, "tail": 1, "bwd": 0, "bwd_y": 1,
          "bwd_e": 1, "bwd_g": 1, "bwd_gy": 1}


def floor_bytes(work: dict):
    """Bytes over the counters in ``work``, or None without a lag-route
    launch."""
    if not work.get("work.css_lag_launches"):
        return None
    floats = sum(PANELS.get(k[len(PREFIX):], 0) * n for k, n in work.items()
                 if k.startswith(PREFIX))
    floats += work.get("work.css_lag_row_floats", 0)
    floats += work.get("work.css_lag_coef_floats", 0)
    return WORD * floats


def floor_ms(work: dict):
    """The bytes' time at the card's bandwidth, in ms, or None."""
    b = floor_bytes(work)
    return None if b is None else 1e3 * b / HBM_BYTES_PER_S
