"""Model registry — `model_entry(config)` equivalent
(reference: prototype/model/__init__.py:15-21)."""

from declip_tpu_torch.utils.registry import MODELS

# importing registers the factories
from declip_tpu_torch.models import clip_model  # noqa: F401
from declip_tpu_torch.models import declip_model  # noqa: F401
from declip_tpu_torch.models import defilip_model  # noqa: F401
from declip_tpu_torch.models import filip_model  # noqa: F401
from declip_tpu_torch.models import slip_model  # noqa: F401
from declip_tpu_torch.models import ssl_builders  # noqa: F401


def model_entry(config, data_group=None, **extra):
    """Build a model from a `{type, kwargs}` config node; ``extra`` (e.g.
    ``device``) goes to the factory beside the config kwargs. With a
    ``data_group`` (``parallel.Group``), its BatchNorms take their moments
    across the group's ranks as the image tower's ``use_sync_bn`` and
    ``bn_group_size`` say (``clip_model.bind_data_group``)."""
    model = MODELS.build(config, **extra)
    if data_group is not None:
        image = dict((config.get("kwargs") or {}).get("image_encode") or {})
        clip_model.bind_data_group(
            model, data_group,
            use_sync_bn=image.get("use_sync_bn", True),
            bn_group_size=int(image.get("bn_group_size") or 1))
    return model
