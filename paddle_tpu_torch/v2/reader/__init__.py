"""Reader combinators and creators (``paddle_tpu/v2/reader/``)."""

from paddle_tpu_torch.v2.reader.decorator import (
    ComposeNotAligned,
    buffered,
    cache,
    chain,
    compose,
    firstn,
    map_readers,
    pipe_reader,
    shuffle,
    xmap_readers,
)
from paddle_tpu_torch.v2.reader import creator
