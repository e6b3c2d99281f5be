"""The v1 config DSL (``paddle_tpu/trainer_config_helpers/``).  A v1
config calls ``settings(...)``, builds a layer graph with ``*_layer``
constructors and declares ``outputs(...)``; ``paddle_tpu_torch.trainer.config_parser.
parse_config`` runs it and returns what it declared.  The constructors
build the lazy ``LayerOutput`` DAG of ``paddle_tpu_torch.v2.layer``, so
a parsed config trains on the port's Program path; the evaluators
(``evaluators.py``) attach metric and printer layers beside it, and
``layer_math`` adds the ``+``, ``-`` and ``*`` overloads on layers;
``default_decorators``, ``utils`` and ``config_parser_utils`` are the
helpers user extensions and the v2 modules call."""

from paddle_tpu_torch.trainer_config_helpers.activations import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.attrs import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.poolings import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.layers import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.layers_extra import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.networks import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.optimizers import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.data_sources import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.default_decorators import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.evaluators import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers.utils import *  # noqa: F401,F403
from paddle_tpu_torch.trainer_config_helpers import config_parser_utils  # noqa: F401

# the operator overloads on LayerOutput and the layer_math namespace
from paddle_tpu_torch.trainer_config_helpers import layer_math  # noqa: E402,F401
