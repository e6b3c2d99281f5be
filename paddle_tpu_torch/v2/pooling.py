"""Sequence pooling types (``paddle_tpu/v2/pooling.py``)."""


class BasePoolingType:
    name = None


class Max(BasePoolingType):
    name = "max"

    def __init__(self, output_max_index=False):
        self.output_max_index = output_max_index


class Avg(BasePoolingType):
    name = "avg"


class Sum(BasePoolingType):
    name = "sum"


class SquareRootN(BasePoolingType):
    name = "sqrt"
