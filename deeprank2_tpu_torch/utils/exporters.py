"""Epoch-granular training-output sinks (behavior parity with the reference
plugin surface, deeprank2/utils/exporters.py:16-336).

An exporter receives, once per pass per epoch, the tuple ``(pass_name,
epoch_number, entry_names, output_values, target_values, loss)`` and may do
anything with it; the Trainer validates each exporter against the model's
output/target shapes up front (``is_compatible_with``) and drives the
collection as a context manager around ``train``/``test``. Three built-ins
ship, matching the reference set:

- :class:`HDF5OutputExporter` — every datapoint into one HDF5 file, pandas-
  readable via :meth:`HDF5OutputExporter.read`. Written with h5py directly
  (pandas ``to_hdf`` would pull in pytables, which this repo does not carry).
- :class:`TensorboardBinaryClassificationExporter` — per-epoch cross
  entropy, MCC, accuracy and ROC AUC scalars, computed in numpy/sklearn
  rather than torch.
- :class:`ScatterPlotExporter` — truth-vs-prediction scatter images on a
  configurable epoch interval.

The port's copy of ``deeprank2_tpu/utils/exporters.py``; h5py, pandas,
sklearn, matplotlib and tensorboard load inside the functions that use them.
"""

from __future__ import annotations

import math
import os
import random

import numpy as np

DEFAULT_OUTPUT_DIR = "./output"


class OutputExporter:
    """Base sink: owns an output directory, defines the plugin hooks.

    Subclasses override :meth:`process` (and usually
    :meth:`is_compatible_with`); the context-manager hooks bracket a whole
    train/test run so sinks can hold state across epochs.
    """

    def __init__(self, directory_path: str | None = None) -> None:
        self._directory_path = DEFAULT_OUTPUT_DIR if directory_path is None else directory_path
        os.makedirs(self._directory_path, exist_ok=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc_info) -> None:
        pass

    def process(
        self,
        pass_name: str,
        epoch_number: int,
        entry_names: list[str],
        output_values: list,
        target_values: list,
        loss: float,
    ) -> None:
        """Consume one pass's worth of per-entry outputs (the three lists are
        index-aligned and equally long)."""

    def is_compatible_with(self, output_data_shape: int, target_data_shape: int | None = None) -> bool:  # noqa: ARG002
        """Whether this sink can handle the model's output/target widths."""
        return True


class OutputExporterCollection:
    """Fans every hook out to a set of exporters."""

    def __init__(self, *exporters: OutputExporter) -> None:
        self._exporters = exporters

    def __enter__(self):
        for ex in self._exporters:
            ex.__enter__()
        return self

    def __exit__(self, *exc_info) -> None:
        for ex in self._exporters:
            ex.__exit__(*exc_info)

    def process(self, *epoch_args) -> None:
        for ex in self._exporters:
            ex.process(*epoch_args)

    def __iter__(self):
        return iter(self._exporters)


def binary_classification_metrics(outputs: np.ndarray, targets: np.ndarray) -> dict[str, float]:
    """Epoch metrics for 2-class probability outputs: cross entropy, MCC,
    accuracy, and (when both classes are present) ROC AUC.

    The trainer exports softmax probabilities, so cross entropy re-logs them
    (renormalized — torch ``CrossEntropyLoss`` parity on logits that were
    already softmaxed). MCC follows the reference's convention of emitting
    0 when the numerator vanishes and nothing at all when only the
    denominator does (deeprank2/utils/exporters.py:134-151).
    """
    n = targets.shape[0]
    logp = np.log(np.clip(outputs, 1e-12, None))
    logp -= np.log(np.exp(logp).sum(axis=1, keepdims=True))
    metrics = {"cross entropy loss": float(-logp[np.arange(n), targets].mean())}

    predicted = outputs.argmax(axis=1)
    # confusion counts: index = 2*truth + prediction
    cm = np.bincount(2 * (targets > 0) + (predicted > 0), minlength=4)
    tn, fp, fn, tp = (int(c) for c in cm)
    mcc_num = tn * tp - fp * fn
    if mcc_num == 0:
        metrics["MCC"] = 0.0
    else:
        mcc_den = math.sqrt((tn + fn) * (fp + tp) * (tn + fp) * (fn + tp))
        if mcc_den != 0:
            metrics["MCC"] = mcc_num / mcc_den
    metrics["accuracy"] = (tp + tn) / max(n, 1)

    if np.unique(targets).shape[0] == 2:  # noqa: PLR2004
        import sklearn.metrics as skm

        metrics["ROC AUC"] = float(skm.roc_auc_score(targets, outputs[:, 1]))
    return metrics


class TensorboardBinaryClassificationExporter(OutputExporter):
    """Binary-classification scalars (cross entropy / MCC / accuracy /
    ROC AUC) into a TensorBoard event file, one point per epoch per pass."""

    def __init__(self, directory_path: str) -> None:
        super().__init__(directory_path)
        from torch.utils import tensorboard

        self._writer = tensorboard.SummaryWriter(log_dir=directory_path)

    def __enter__(self):
        self._writer.__enter__()
        return self

    def __exit__(self, *exc_info) -> None:
        self._writer.__exit__(*exc_info)

    def process(
        self,
        pass_name: str,
        epoch_number: int,
        entry_names: list[str],  # noqa: ARG002
        output_values: list,
        target_values: list,
        loss: float,  # noqa: ARG002
    ) -> None:
        metrics = binary_classification_metrics(
            np.asarray(output_values, dtype=np.float64),
            np.asarray(target_values, dtype=np.int64),
        )
        for tag, value in metrics.items():
            self._writer.add_scalar(f"{pass_name} {tag}", value, epoch_number)

    def is_compatible_with(self, output_data_shape: int, target_data_shape: int | None = None) -> bool:
        """Two-class probability rows against scalar class targets."""
        return (output_data_shape, target_data_shape) == (2, 1)


# fixed pass-name -> plot color assignment; anything unrecognized draws from
# the fallback pool
_SERIES_COLORS = {
    "train": "blue",
    "training": "blue",
    "eval": "red",
    "valid": "red",
    "validation": "red",
    "test": "green",
    "testing": "green",
}
_FALLBACK_COLORS = ("yellow", "cyan", "magenta")


class ScatterPlotExporter(OutputExporter):
    """Per-epoch truth(x)-vs-prediction(y) scatter images, redrawn with every
    pass so one PNG accumulates all passes of its epoch."""

    def __init__(self, directory_path: str, epoch_interval: int = 1) -> None:
        super().__init__(directory_path)
        self._every = epoch_interval

    def __enter__(self):
        self._series: dict[int, dict[str, tuple]] = {}
        return self

    def __exit__(self, *exc_info) -> None:
        self._series.clear()

    def get_filename(self, epoch_number: int) -> str:
        """Path of this epoch's scatter image."""
        return os.path.join(self._directory_path, f"scatter-{epoch_number}.png")

    def _draw(self, epoch_number: int) -> None:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        plt.title(f"Epoch {epoch_number}")
        for series_name, (truths, predictions) in self._series[epoch_number].items():
            color = _SERIES_COLORS.get(series_name.lower().strip()) or random.choice(_FALLBACK_COLORS)  # noqa: S311
            plt.scatter(truths, predictions, color=color, label=series_name)
        plt.xlabel("truth")
        plt.ylabel("prediction")
        plt.legend()
        plt.savefig(self.get_filename(epoch_number))
        plt.close()

    def process(
        self,
        pass_name: str,
        epoch_number: int,
        entry_names: list[str],  # noqa: ARG002
        output_values: list,
        target_values: list,
        loss: float,  # noqa: ARG002
    ) -> None:
        if epoch_number % self._every == 0:
            self._series.setdefault(epoch_number, {})[pass_name] = (target_values, output_values)
            self._draw(epoch_number)

    def is_compatible_with(self, output_data_shape: int, target_data_shape: int | None = None) -> bool:
        """Scalar regression outputs against scalar targets."""
        return (output_data_shape, target_data_shape) == (1, 1)


class HDF5OutputExporter(OutputExporter):
    """The default, most general sink: every (phase, epoch, entry, output,
    target, loss) datapoint lands in ``output_exporter.hdf5``, grouped by
    phase, and reads back as a pandas DataFrame via :meth:`read`."""

    def __init__(self, directory_path: str) -> None:
        self.phase = None
        super().__init__(directory_path)

    def __enter__(self):
        self._rows: list[tuple] = []
        return self

    def __exit__(self, *exc_info) -> None:
        if self.phase is not None:
            # train+validation runs flush under "training" (reference quirk:
            # both passes share the table keyed by the final training phase)
            self._flush("training" if self.phase == "validation" else self.phase)

    @property
    def path(self) -> str:
        return os.path.join(self._directory_path, "output_exporter.hdf5")

    def _flush(self, key: str) -> None:
        import h5py

        rows = self._rows
        with h5py.File(self.path, "a") as f:
            if key in f:
                del f[key]
            grp = f.create_group(key)
            grp.create_dataset("phase", data=np.array([r[0] for r in rows]).astype("S"))
            # epoch may be None when testing a pretrained model whose
            # checkpoint predates a best-model save (the reference stores
            # NaN via pandas in that case) -> -1 marks "unknown epoch"
            grp.create_dataset("epoch", data=np.array([-1 if r[1] is None else r[1] for r in rows], dtype=np.int64))
            grp.create_dataset("entry", data=np.array([r[2] for r in rows]).astype("S"))
            outputs = [np.atleast_1d(np.asarray(r[3], dtype=np.float64)) for r in rows]
            width = max((o.shape[0] for o in outputs), default=1)
            grp.create_dataset("output", data=np.stack([np.pad(o, (0, width - o.shape[0])) for o in outputs]) if rows else np.zeros((0, 1)))
            for col, idx in (("target", 4), ("loss", 5)):
                grp.create_dataset(col, data=np.array([np.nan if r[idx] is None else float(r[idx]) for r in rows], dtype=np.float64))

    def read(self, phase: str):
        """One phase back as a DataFrame (reference column layout)."""
        import h5py
        import pandas as pd

        with h5py.File(self.path, "r") as f:
            grp = f[phase]
            outputs = grp["output"][()]
            return pd.DataFrame(
                {
                    "phase": [s.decode() for s in grp["phase"][()]],
                    "epoch": grp["epoch"][()],
                    "entry": [s.decode() for s in grp["entry"][()]],
                    "output": [row.tolist() if row.shape[0] > 1 else float(row[0]) for row in outputs],
                    "target": grp["target"][()],
                    "loss": grp["loss"][()],
                }
            )

    def process(
        self,
        pass_name: str,
        epoch_number: int,
        entry_names: list[str],
        output_values: list,
        target_values: list,
        loss: float,
    ) -> None:
        self.phase = pass_name
        for name, output, target in zip(entry_names, output_values, target_values):
            self._rows.append((pass_name, epoch_number, name, output, target, loss))
