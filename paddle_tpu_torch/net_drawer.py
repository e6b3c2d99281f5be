"""Program visualization (``paddle_tpu/net_drawer.py``; reference:
python/paddle/v2/fluid/net_drawer.py, graphviz rendering of the op
graph).  Emits DOT text, the same text as the JAX package for the same
program; rendering is the caller's concern (graphviz is no runtime
dependency)."""

from __future__ import annotations

from paddle_tpu_torch import framework


def draw_graph(program=None, block_idx: int = 0, name: str = "program"):
    """DOT source for one block: op nodes (box), var nodes (ellipse,
    parameters shaded), edges input -> op -> output."""
    program = program or framework.default_main_program()
    block = program.blocks[block_idx]
    lines = [f"digraph {name} {{", "  rankdir=TB;"]
    seen_vars = set()

    def var_node(v):
        if v in seen_vars:
            return
        seen_vars.add(v)
        var = block.find_var(v)
        is_param = var is not None and isinstance(var, framework.Parameter)
        style = ' style=filled fillcolor="lightgrey"' if is_param else ""
        shape = ""
        if var is not None and var.shape is not None:
            shape = " " + "x".join(str(s) for s in var.shape)
        lines.append(f'  "{v}" [shape=ellipse label="{v}{shape}"{style}];')

    for i, op in enumerate(block.ops):
        op_id = f"op{i}_{op.type}"
        lines.append(f'  "{op_id}" [shape=box label="{op.type}" '
                     'style=filled fillcolor="lightblue"];')
        for v in op.input_arg_names:
            var_node(v)
            lines.append(f'  "{v}" -> "{op_id}";')
        for v in op.output_arg_names:
            var_node(v)
            lines.append(f'  "{op_id}" -> "{v}";')
    lines.append("}")
    return "\n".join(lines)


def save_graph(path: str, program=None, block_idx: int = 0):
    dot = draw_graph(program, block_idx)
    with open(path, "w") as f:
        f.write(dot)
    return path
