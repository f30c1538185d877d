"""Model factory registry: config factory strings -> Model builders.

Every model family of the JAX package: the FEMNIST CNN family
(``leaf.femnist[.variant]`` / ``examples.leaf.LEAFFEMNISTModel``), the
CelebA CNN (``leaf.celeba`` / ``examples.leaf.LEAFCelebAModel``), the
Shakespeare char-LSTM (``leaf.shakespeare``), the plain ``mlp`` and the
evidential wearable MLPs (``examples.wearables.<kind>`` /
``wearables.<kind>``), with the JAX package's defaults and parameter names.
The two CNNs take ``conv_impl`` (``direct`` or ``im2col``).
"""

from typing import Any, Dict

from murmura_tpu_torch.models.cnn import FEMNIST_VARIANTS, make_celeba_cnn, make_femnist_cnn
from murmura_tpu_torch.models.core import Model
from murmura_tpu_torch.models.lstm import make_char_lstm
from murmura_tpu_torch.models.mlp import make_mlp, make_wearable_mlp

# The wearable datasets' default widths (the JAX package's registry): UCI
# HAR 561 features; PAMAP2 a 100-sample window of 40 features; PPG-DaLiA a
# 32-sample window of 6.
WEARABLE_DEFAULTS = {
    "uci_har": {"input_dim": 561, "hidden_dims": (256, 128), "num_classes": 6},
    "pamap2": {"input_dim": 4000, "hidden_dims": (512, 256, 128), "num_classes": 12},
    "ppg_dalia": {"input_dim": 192, "hidden_dims": (256, 128, 64), "num_classes": 7},
}


def build_model(factory: str, params: Dict[str, Any]) -> Model:
    """Resolve a config ``model.factory`` string to a Model.  A config's
    ``params`` override a wearable kind's defaults."""
    params = dict(params or {})
    f = factory.strip()
    compute_dtype = params.pop("compute_dtype", None)
    if f == "mlp":
        return make_mlp(
            input_dim=int(params.pop("input_dim", 32)),
            hidden_dims=tuple(params.pop("hidden_dims", (64, 32))),
            num_classes=int(params.pop("num_classes", 10)),
            dropout_rate=float(params.pop("dropout", 0.0)),
            evidential=bool(params.pop("evidential", False)),
            compute_dtype=compute_dtype,
        )
    lowered = f.lower()
    if "femnist" in lowered:
        variant = params.pop("variant", None)
        if variant is None:
            tail = lowered.rsplit(".", 1)[-1]
            variant = tail if tail in FEMNIST_VARIANTS else "baseline"
        return make_femnist_cnn(
            num_classes=int(params.pop("num_classes", 62)), variant=variant,
            compute_dtype=compute_dtype,
            conv_impl=params.pop("conv_impl", "direct"),
        )
    if "celeba" in lowered:
        return make_celeba_cnn(
            num_classes=int(params.pop("num_classes", 2)),
            compute_dtype=compute_dtype,
            conv_impl=params.pop("conv_impl", "direct"),
        )
    if "shakespeare" in lowered:
        return make_char_lstm(
            vocab_size=int(params.pop("vocab_size", 81)),
            embed_dim=int(params.pop("embed_dim", 8)),
            hidden=int(params.pop("hidden", 256)),
            num_layers=int(params.pop("num_layers", 2)),
            seq_len=int(params.pop("seq_len", 80)),
            compute_dtype=compute_dtype,
        )
    for prefix in ("examples.wearables.", "wearables."):
        if f.startswith(prefix):
            kind = f[len(prefix):]
            defaults = dict(WEARABLE_DEFAULTS.get(kind, WEARABLE_DEFAULTS["uci_har"]))
            defaults.update(params)
            return make_wearable_mlp(
                input_dim=int(defaults["input_dim"]),
                hidden_dims=tuple(defaults["hidden_dims"]),
                num_classes=int(defaults["num_classes"]),
                dropout=float(defaults.get("dropout", 0.3)),
                name=f"wearables.{kind}",
                compute_dtype=compute_dtype,
            )
    raise ValueError(f"Unknown model factory: {factory!r}")
