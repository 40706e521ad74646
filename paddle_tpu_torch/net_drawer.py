"""Program -> Graphviz dot export (reference python/paddle/fluid/net_drawer.py
+ graphviz.py; also the ir graph_viz_pass's user-visible role). No graphviz
binary dependency: emits dot text; render externally if desired. The port's
copy of ``paddle_tpu/net_drawer.py``: the same dot for the same program."""
from __future__ import annotations


def draw_graph(startup_program, main_program=None, **kwargs):
    """Reference net_drawer.draw_graph signature; returns the dot source of
    the main program (startup accepted for parity)."""
    prog = main_program if main_program is not None else startup_program
    return program_to_dot(prog, **kwargs)


def program_to_dot(program, graph_name: str = "program",
                   max_label: int = 40) -> str:
    """One dot digraph for the program's global block: op nodes (boxes) and
    var nodes (ellipses; parameters shaded), edges by producer/consumer."""
    block = program.global_block()
    lines = [f'digraph "{graph_name}" {{', "  rankdir=TB;"]

    def esc(s):
        return s.replace('"', r'\"')

    def label(s):
        # labels truncate for readability; node IDs always use the full name
        # so distinct long names never collide
        s = s if len(s) <= max_label else s[:max_label - 3] + "..."
        return esc(s)

    var_nodes = set()

    def var_node(name):
        if name in var_nodes:
            return
        var_nodes.add(name)
        v = block.find_var_recursive(name)
        shape = tuple(v.shape) if v is not None else "?"
        is_param = v is not None and getattr(v, "trainable", False)
        style = ', style=filled, fillcolor="lightgrey"' if is_param else ""
        lines.append(f'  "v_{esc(name)}" [label="{label(name)}\\n{shape}", '
                     f'shape=ellipse{style}];')

    for i, op in enumerate(block.ops):
        lines.append(f'  "op_{i}" [label="{label(op.type)}", shape=box, '
                     f'style=filled, fillcolor="lightblue"];')
        for names in op.inputs.values():
            for n in names:
                var_node(n)
                lines.append(f'  "v_{esc(n)}" -> "op_{i}";')
        for names in op.outputs.values():
            for n in names:
                var_node(n)
                lines.append(f'  "op_{i}" -> "v_{esc(n)}";')
    lines.append("}")
    return "\n".join(lines)
