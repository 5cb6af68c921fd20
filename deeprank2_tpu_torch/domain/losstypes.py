"""Loss-function validity whitelists per task (port of
``deeprank2_tpu/domain/losstypes.py``, over the port's loss classes).

The registry maps each loss class of ``ops/losses.py`` to the task family it
is valid for; the module-level tuples below are derived views kept for API
parity with the reference framework's whitelists
(deeprank2/domain/losstypes.py).
"""

from deeprank2_tpu_torch.ops import losses as _losses

_REGISTRY: dict[type, str] = {
    # regression
    _losses.L1Loss: "regression",
    _losses.SmoothL1Loss: "regression",
    _losses.MSELoss: "regression",
    _losses.HuberLoss: "regression",
    # binary classification
    _losses.SoftMarginLoss: "binary",
    _losses.BCELoss: "binary",
    _losses.BCEWithLogitsLoss: "binary",
    # multiclass classification
    _losses.CrossEntropyLoss: "multiclass",
    _losses.NLLLoss: "multiclass",
    _losses.PoissonNLLLoss: "multiclass",
    _losses.GaussianNLLLoss: "multiclass",
    _losses.KLDivLoss: "multiclass",
    _losses.MultiLabelMarginLoss: "multiclass",
    _losses.MultiLabelSoftMarginLoss: "multiclass",
    # valid for neither task family (rejected unless override_invalid)
    _losses.HingeEmbeddingLoss: "other",
    _losses.CosineEmbeddingLoss: "other",
    _losses.MarginRankingLoss: "other",
    _losses.TripletMarginLoss: "other",
    _losses.CTCLoss: "other",
}


def _family(name: str) -> tuple[type, ...]:
    return tuple(cls for cls, fam in _REGISTRY.items() if fam == name)


regression_losses = _family("regression")
binary_classification_losses = _family("binary")
multi_classification_losses = _family("multiclass")
other_losses = _family("other")

classification_losses = multi_classification_losses + binary_classification_losses

# classification losses with validated Trainer output formatting
classification_tested = (
    _losses.CrossEntropyLoss,
    _losses.NLLLoss,
    _losses.BCELoss,
    _losses.BCEWithLogitsLoss,
)
