"""Topology: walk the v2 layer DAG and emit a Program
(``paddle_tpu/v2/topology.py``)."""

from __future__ import annotations

from typing import List, Optional

from paddle_tpu_torch import framework
from paddle_tpu_torch.v2.layer import LayerOutput


class Topology:
    def __init__(self, cost: Optional[LayerOutput] = None,
                 extra_layers: Optional[List[LayerOutput]] = None,
                 output_layers: Optional[List[LayerOutput]] = None,
                 is_test: bool = False):
        outputs = list(output_layers or [])
        if cost is not None:
            outputs = [cost] + outputs
        outputs += list(extra_layers or [])
        self.output_layers = outputs  # LayerOutputs, as output_vars
        self.cost = cost
        self.main_program = framework.Program()
        self.startup_program = framework.Program()
        self.ctx: dict = {"@is_test": is_test}
        # a fresh unique-name generator for the build, so the same DAG
        # names its parameters the same on every build (and as the JAX
        # package's Topology does: weights cross by name)
        saved_gen = framework._name_gen
        framework._name_gen = framework._UniqueNameGenerator()
        try:
            with framework.program_guard(self.main_program,
                                         self.startup_program):
                self.output_vars = []
                for lo in outputs:
                    v = lo.build(self.ctx)
                    self.output_vars.append(v.var if hasattr(v, "var") else v)
        finally:
            framework._name_gen = saved_gen
        self.cost_var = self.output_vars[0] if cost is not None else None
        # (name, InputType) in declaration order
        self.feed_types = normalize_feeds(self.ctx.get("@feeds", []))

    def data_layers(self):
        return {name: t for name, t in self.feed_types}

    def feed_names(self):
        return [name for name, _ in self.feed_types]


def normalize_feeds(entries):
    """(name, type[, decl_order]) entries -> [(name, type)] in
    declaration order, deduped by name."""
    seen = {}
    for e in entries:
        name, t = e[0], e[1]
        order = e[2] if len(e) > 2 else len(seen)
        if name not in seen:
            seen[name] = (order, t)
    return [(n, t) for n, (o, t) in sorted(seen.items(),
                                            key=lambda kv: kv[1][0])]
