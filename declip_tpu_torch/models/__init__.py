"""Model registry — `model_entry(config)` equivalent
(reference: prototype/model/__init__.py:15-21)."""

from declip_tpu_torch.utils.registry import MODELS

# importing registers the factories
from declip_tpu_torch.models import clip_model  # noqa: F401
from declip_tpu_torch.models import declip_model  # noqa: F401
from declip_tpu_torch.models import defilip_model  # noqa: F401
from declip_tpu_torch.models import filip_model  # noqa: F401
from declip_tpu_torch.models import slip_model  # noqa: F401


def model_entry(config, **extra):
    """Build a model from a `{type, kwargs}` config node; ``extra`` (e.g.
    ``device``) goes to the factory beside the config kwargs."""
    return MODELS.build(config, **extra)
