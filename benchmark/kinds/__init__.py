"""The kinds of traffic, one module a kind (``kinds/<kind>.py``, the name a
traffic file's ``kind`` gives), each the generator of its traffic files'
work. The harness (``harness.run_cell``) drives one through these
functions, and times the window itself:

- ``setup(cell, seed, device, rt, spans, trace)``: the program's objects
  from the cell's data, the first unit and the warm-up units; returns a
  context (``ctx.extra``: a dict of what the run saw, printed on stderr);
- ``unit(ctx, i, traced)``: the window's unit ``i``, in the benchmark's
  spans (``traced``: it runs in the profiled sub-window);
- ``metrics(ctx, units, window_s, times)``: the end-to-end readings by
  name (``times``: each unit's seconds on the host clock);
- ``replay(ctx, skip, n, recorder)``: after the window, the profiled
  units ``skip`` to ``skip + n`` again, with ``recorder.on`` (the
  harness's record of the program's march calls) true while they run;
- ``compare(ctx, device)``: the compared numbers, from the plain reference
  once the program's state is freed;
- ``control(cell, seed, device, mode)``: the same numbers with the
  reference in the lower precision ``mode`` in the program's place (what
  ``calibrate.py`` reads).
"""
