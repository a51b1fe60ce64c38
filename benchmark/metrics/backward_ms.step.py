"""Per-layer metric ``backward_ms.step``, and
``backward_ms.step.<qualifier>``, the same reading under the bound of its
cells' regime, (ms): the host time of the benchmark's ``bench.backward``
span around ``torch.autograd.grad``, synchronised before and after it in
the traced run, a step. Returns None where the traced run has nothing to
read."""


def read(tr):
    spans = [d for n, _, d in tr.spans if n == "bench.backward"]
    if tr.kind != "grad" or not spans:
        return None
    return sum(spans) / 1e3 / len(spans)
