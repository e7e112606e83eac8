"""The port's model modules; importing registers the ported core and readout."""

from v1t_tpu_torch.models.cores import vit  # noqa: F401  (registers "vit")
from v1t_tpu_torch.models.readouts import gaussian2d  # noqa: F401  (registers "gaussian2d")
from v1t_tpu_torch.models.model import Model, build_model, model_regularizer, param_labels

__all__ = ["Model", "build_model", "model_regularizer", "param_labels"]
