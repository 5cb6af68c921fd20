"""Host milliseconds of an optimizer step: the mean length of torch's
``Optimizer.step#<class>.step`` spans in the window's trace (the port's
``ops/optim.py:Adam`` subclasses ``torch.optim.Optimizer``, which records
them)."""


def read(ctx, phase):
    if phase != ctx.phase or ctx.trace is None:
        return None
    spans = [s for name, ss in ctx.trace.spans_s.items() if name.startswith("Optimizer.step#") for s in ss]
    return 1e3 * sum(spans) / len(spans) if spans else None
