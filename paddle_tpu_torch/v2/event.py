"""Training events (``paddle_tpu/v2/event.py``)."""


class WithMetric:
    def __init__(self, evaluator=None):
        self._evaluator = evaluator


class BeginPass:
    def __init__(self, pass_id):
        self.pass_id = pass_id


class EndPass(WithMetric):
    def __init__(self, pass_id, evaluator=None, gm=None):
        self.pass_id = pass_id
        super().__init__(evaluator)


class BeginIteration:
    def __init__(self, pass_id, batch_id):
        self.pass_id = pass_id
        self.batch_id = batch_id


class EndIteration(WithMetric):
    def __init__(self, pass_id, batch_id, cost, evaluator=None, gm=None,
                 metrics=None):
        self.pass_id = pass_id
        self.batch_id = batch_id
        self.cost = cost
        self.metrics = metrics or {}
        super().__init__(evaluator)


class TestResult(WithMetric):
    def __init__(self, evaluator=None, cost=None, metrics=None):
        self.cost = cost
        self.metrics = metrics or {}
        super().__init__(evaluator)
