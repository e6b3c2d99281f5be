"""Helper-layer utilities (``paddle_tpu/trainer_config_helpers/utils.py``)."""

import functools
import logging

logger = logging.getLogger(__name__)

__all__ = ["deprecated"]


def deprecated(instead):
    """Mark a helper as deprecated, pointing at its replacement."""

    def __impl__(func):
        @functools.wraps(func)
        def __wrapper__(*args, **kwargs):
            logger.warning(
                "The interface %s is deprecated, will be removed soon. "
                "Please use %s instead.", func.__name__, instead)
            return func(*args, **kwargs)

        return __wrapper__

    return __impl__
