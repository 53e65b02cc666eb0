"""``[module, Class]`` config names → the port's constructors (counterpart
of ``multi_degradation_image_enhancement_tpu/utils/registry.py``).

The shipped configs name the reference's modules (``["models.cdan",
"CDAN"]``); each name that the train and test phases of the shipped
configs use (synthetic and directory-backed) maps to the port's class, in
the short and in the long form, as does the port's second network,
``["models.restormer", "Restormer"]`` (``config/restormer_noise_synthetic.json``).
Any other name raises and names ROADMAP.md.  Every error raised while an object is built reaches the caller
as the JAX registry's ``NotImplementedError("<init_type> [<Class>() from
<module>] not recognized: <error>")``, chained to it (``utils/registry.py:
80-99``).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Tuple

_PKG = "multi_degradation_image_enhancement_tpu_torch"


def _cdan():
    from multi_degradation_image_enhancement_tpu_torch.models.cdan import CDAN
    return CDAN


def _restormer():
    from multi_degradation_image_enhancement_tpu_torch.models.restormer import Restormer
    return Restormer


def _model():
    from multi_degradation_image_enhancement_tpu_torch.engine.model import Model
    return Model


def _paired():
    from multi_degradation_image_enhancement_tpu_torch.data.dataset import PairedDataset
    return PairedDataset


def _unpaired():
    from multi_degradation_image_enhancement_tpu_torch.data.dataset import UnpairedDataset
    return UnpairedDataset


def _synthetic():
    from multi_degradation_image_enhancement_tpu_torch.data.synthetic import SyntheticPairedDataset
    return SyntheticPairedDataset


_REGISTRY: Dict[Tuple[str, str], Callable[[], Any]] = {
    ("models.cdan", "CDAN"): _cdan,
    (f"{_PKG}.models.cdan", "CDAN"): _cdan,
    ("models.restormer", "Restormer"): _restormer,
    (f"{_PKG}.models.restormer", "Restormer"): _restormer,
    ("models.model", "Model"): _model,
    (f"{_PKG}.engine.model", "Model"): _model,
    ("data.synthetic", "SyntheticPairedDataset"): _synthetic,
    (f"{_PKG}.data.synthetic", "SyntheticPairedDataset"): _synthetic,
    ("data.dataset", "PairedDataset"): _paired,
    (f"{_PKG}.data.dataset", "PairedDataset"): _paired,
    ("data.dataset", "UnpairedDataset"): _unpaired,
    (f"{_PKG}.data.dataset", "UnpairedDataset"): _unpaired,
}


def resolve(module_path: str, class_name: str) -> Any:
    try:
        return _REGISTRY[(module_path, class_name)]()
    except KeyError:
        raise NotImplementedError(
            f"[{class_name}() from {module_path}] is not ported to PyTorch yet (ROADMAP.md)"
        ) from None


def init_obj(obj_config: Dict[str, Any], *args: Any, init_type: str = "Network",
             **modify_kwargs: Any) -> Any:
    """Instantiate ``obj_config["name"]`` (``[module, Class]``) with
    ``obj_config["args"]`` updated by ``modify_kwargs``; any failure raises
    ``NotImplementedError`` naming ``init_type`` and the class, from it."""
    name = obj_config["name"]
    if not isinstance(name, list):
        raise NotImplementedError(f"a bare class name ({name!r}) is not ported; use [module, Class]")
    module_path, class_name = name[0], name[1]
    kwargs = dict(obj_config.get("args", {}) or {})
    kwargs.update(modify_kwargs)
    try:
        return resolve(module_path, class_name)(*args, **kwargs)
    except Exception as e:  # the JAX registry's contract (the reference's too)
        raise NotImplementedError(
            f"{init_type} [{class_name}() from {module_path}] not recognized: {e}") from e


def create_model(**cfg_model: Any) -> Any:
    """The engine from ``config["model"]["which_model"]``."""
    model_config = dict(cfg_model["config"]["model"]["which_model"])
    return init_obj(model_config, init_type="Model", **cfg_model)


def define_network(network_config: Dict[str, Any]) -> Any:
    return init_obj(network_config, init_type="Network")


def define_dataset(dataset_config: Dict[str, Any]) -> Any:
    return init_obj(dataset_config, init_type="Dataset")
