"""Early-stopping policy for the training loop.

Two independent triggers, matching the reference semantics
(deeprank2/utils/earlystopping.py:39-87):

* **stall**: the validation loss has not improved on its running best by more
  than ``delta`` for ``patience`` consecutive evaluations;
* **overfit gap**: once ``epoch > min_epoch``, the spread
  ``val_loss - train_loss`` exceeds ``maxgap``.

State is exposed as plain attributes (``counter``, ``best_score``,
``val_loss_min``, ``early_stop``) so the Trainer can checkpoint and restore a
stopper mid-run. The port's copy of ``deeprank2_tpu/utils/earlystopping.py``.
"""

from __future__ import annotations

from collections.abc import Callable


class EarlyStopping:
    """Stateful stop signal fed once per epoch with the latest losses.

    Args:
        patience: evaluations without sufficient improvement before stopping.
        delta: improvement margin; a new loss must undercut the best by more
            than this to reset the stall counter.
        maxgap: largest tolerated ``val_loss - train_loss`` spread (None
            disables the overfit trigger).
        min_epoch: the overfit trigger stays dormant through this epoch.
        verbose: emit a trace line on every evaluation, not just on stop.
        trace_func: sink for trace lines (e.g. ``logging.info``).
    """

    def __init__(
        self,
        patience: int = 10,
        delta: float = 0,
        maxgap: float | None = None,
        min_epoch: int = 10,
        verbose: bool = True,
        trace_func: Callable = print,
    ):
        self.patience = 10 if patience is None else patience
        self.delta = delta
        self.maxgap = maxgap
        self.min_epoch = min_epoch
        self.verbose = verbose
        self.trace_func = trace_func

        self.early_stop = False
        self.counter = 0
        self.best_score = None  # negated best val loss, kept for checkpoint compat
        self.val_loss_min = None

    def _check_stall(self, epoch: int, val_loss: float) -> None:
        if self.val_loss_min is None:  # first evaluation seeds the running best
            self.val_loss_min = val_loss
        elif val_loss > self.val_loss_min - self.delta:
            self.counter += 1
            if self.verbose:
                margin = f"the {self.delta} margin under " if self.delta else ""
                self.trace_func(
                    f"val loss {val_loss:.6f} did not beat {margin}the best so far "
                    f"{self.val_loss_min:.6f} — stalled {self.counter}/{self.patience}",
                )
            if self.counter >= self.patience:
                self.trace_func(f"early stop at epoch {epoch}: {self.patience} evaluations without improvement")
                self.early_stop = True
        else:
            if self.verbose:
                self.trace_func(f"val loss improved: {self.val_loss_min:.6f} -> {val_loss:.6f}")
            self.counter = 0
        # a new minimum updates the running best even when it lands inside the
        # delta margin (and so still counted as a stall) — reference parity
        if val_loss <= self.val_loss_min:
            self.val_loss_min = val_loss
        self.best_score = -self.val_loss_min

    def _check_gap(self, epoch: int, val_loss: float, train_loss: float | None) -> None:
        if not self.maxgap or epoch <= self.min_epoch:
            return
        if train_loss is None:
            msg = "maxgap is set but no train_loss was passed to EarlyStopping"
            raise ValueError(msg)
        gap = val_loss - train_loss
        if gap > self.maxgap:
            self.trace_func(f"early stop at epoch {epoch}: val-train spread {gap} is over the maxgap limit {self.maxgap}")
            self.early_stop = True

    def __call__(self, epoch: int, val_loss: float, train_loss: float | None = None) -> None:
        self._check_stall(epoch, val_loss)
        self._check_gap(epoch, val_loss, train_loss)
