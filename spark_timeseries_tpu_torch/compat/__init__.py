"""Drop-in compatibility layer mirroring the upstream Python API (port of
``compat/``).

``spark_timeseries_tpu_torch.compat.sparkts`` exposes the upstream
``python/sparkts`` surface: ``time_series_rdd_from_observations``, a
``TimeSeriesRDD`` wrapper, ``DateTimeIndex`` factories, and
``Model.fit_model(...)`` classes — implemented on the PyTorch port, with
no Spark, Py4J, or JVM anywhere.
"""

from . import sparkts

__all__ = ["sparkts"]
