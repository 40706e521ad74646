"""Program debugging / visualization (reference: python/paddle/fluid/debugger.py,
net_drawer.py, graphviz.py; ir graph_viz_pass); the port's copy of
``paddle_tpu/debugger.py``: the same text for the same program."""
from __future__ import annotations

from typing import Optional

from .framework import Program


def pprint_program_codes(program: Program) -> str:
    """Readable listing of the program (reference debugger.py draw_block_graphviz
    sibling)."""
    return str(program)


def draw_graph(program: Program, path: Optional[str] = None,
               block_idx: int = 0) -> str:
    """Emit a graphviz dot of var/op dataflow (reference graph_viz_pass)."""
    block = program.blocks[block_idx]
    lines = ["digraph program {", "  rankdir=TB;",
             '  node [shape=box, fontsize=10];']
    for i, op in enumerate(block.ops):
        op_id = f"op_{i}"
        lines.append(f'  {op_id} [label="{op.type}", style=filled, '
                     f'fillcolor=lightblue];')
        for n in op.input_arg_names():
            vid = f'var_{n.replace(".", "_").replace("@", "_AT_")}'
            lines.append(f'  {vid} [label="{n}", shape=ellipse];')
            lines.append(f"  {vid} -> {op_id};")
        for n in op.output_arg_names():
            vid = f'var_{n.replace(".", "_").replace("@", "_AT_")}'
            lines.append(f'  {vid} [label="{n}", shape=ellipse];')
            lines.append(f"  {op_id} -> {vid};")
    lines.append("}")
    dot = "\n".join(lines)
    if path:
        with open(path, "w") as f:
            f.write(dot)
    return dot


def program_summary(program: Program) -> str:
    """Op-type histogram + var/param counts (reference op_frequence.py)."""
    from collections import Counter
    counts = Counter()
    for b in program.blocks:
        for op in b.ops:
            counts[op.type] += 1
    n_vars = sum(len(b.vars) for b in program.blocks)
    n_params = len(program.all_parameters())
    lines = [f"blocks: {len(program.blocks)}  ops: {sum(counts.values())}  "
             f"vars: {n_vars}  params: {n_params}"]
    for t, c in counts.most_common():
        lines.append(f"  {t:<40}{c:>6}")
    return "\n".join(lines)
