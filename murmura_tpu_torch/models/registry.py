"""Model factory registry: config factory strings -> Model builders.

The port runs the FEMNIST CNN family (``leaf.femnist[.variant]`` /
``examples.leaf.LEAFFEMNISTModel``); every other factory of the JAX
package is refused by name.
"""

from typing import Any, Dict

from murmura_tpu_torch.models.cnn import FEMNIST_VARIANTS, make_femnist_cnn
from murmura_tpu_torch.models.core import Model


def build_model(factory: str, params: Dict[str, Any]) -> Model:
    """Resolve a config ``model.factory`` string to a Model."""
    params = dict(params or {})
    f = factory.strip()
    compute_dtype = params.pop("compute_dtype", None)
    lowered = f.lower()
    if "femnist" in lowered:
        variant = params.pop("variant", None)
        if variant is None:
            tail = lowered.rsplit(".", 1)[-1]
            variant = tail if tail in FEMNIST_VARIANTS else "baseline"
        conv_impl = params.pop("conv_impl", "direct")
        if conv_impl != "direct":
            raise ValueError(
                f"conv_impl '{conv_impl}' is not ported; the PyTorch port "
                "runs the direct convolution"
            )
        return make_femnist_cnn(
            num_classes=int(params.pop("num_classes", 62)), variant=variant,
            compute_dtype=compute_dtype,
        )
    raise ValueError(
        f"model factory '{factory}' is not ported to the PyTorch package yet "
        "(ported: the leaf.femnist CNN family)"
    )
