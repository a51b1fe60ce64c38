"""Per-layer metrics: one reader file a metric, ``<name>.py`` with a
``read(trace)`` function (``trace.Trace``), and ``work.py``, the frozen
count of a march call's work and the H100's published peaks."""
