#!/usr/bin/env python
"""API-surface signature printer: the port's copy of
``tools/print_signatures.py``. Emits one sorted line per public callable of
the port:

    <module path>.<name> <inspect signature>

    python -m paddle_tpu_torch.tools.print_signatures [--as-reference]

walks the modules of the JAX package's list under ``paddle_tpu_torch``
(``tools.ckpt_doctor`` is ``paddle_tpu_torch.tools.ckpt_doctor``).
``--as-reference`` prints each path under the JAX package's name
(``paddle_tpu.<...>``, ``tools.ckpt_doctor``), so the output diffs line by
line against ``tests/api_spec.txt``. The modules ``comm`` and ``online``
belong to ROADMAP item 13 and are not in the port yet (``NOT_PORTED``):
they are skipped with a line on stderr.
"""
import argparse
import inspect
import sys

PORT = "paddle_tpu_torch"
REFERENCE = "paddle_tpu"

MODULES = [
    "paddle_tpu_torch.layers",
    "paddle_tpu_torch.optimizer",
    "paddle_tpu_torch.io",
    "paddle_tpu_torch.initializer",
    "paddle_tpu_torch.clip",
    "paddle_tpu_torch.regularizer",
    "paddle_tpu_torch.metrics",
    "paddle_tpu_torch.nets",
    "paddle_tpu_torch.dygraph",
    "paddle_tpu_torch.layers.distributions",
    "paddle_tpu_torch.contrib.slim",
    "paddle_tpu_torch.contrib.mixed_precision",
    "paddle_tpu_torch.contrib.quantize",
    "paddle_tpu_torch.analysis",
    "paddle_tpu_torch.comm",
    "paddle_tpu_torch.tuning",
    "paddle_tpu_torch.resilience",
    "paddle_tpu_torch.data",
    "paddle_tpu_torch.observability",
    "paddle_tpu_torch.online",
    "paddle_tpu_torch.serving",
    "paddle_tpu_torch.warmstore",
    "paddle_tpu_torch.utils.checkpointer",
    "paddle_tpu_torch.tools.ckpt_doctor",
]


def _imported() -> dict:
    """The modules of MODULES that the port has, imported, each named in full
    (the port imports no module by a computed name)."""
    import paddle_tpu_torch.analysis  # noqa: F401
    import paddle_tpu_torch.clip  # noqa: F401
    import paddle_tpu_torch.contrib.mixed_precision  # noqa: F401
    import paddle_tpu_torch.contrib.quantize  # noqa: F401
    import paddle_tpu_torch.contrib.slim  # noqa: F401
    import paddle_tpu_torch.data  # noqa: F401
    import paddle_tpu_torch.dygraph  # noqa: F401
    import paddle_tpu_torch.initializer  # noqa: F401
    import paddle_tpu_torch.io  # noqa: F401
    import paddle_tpu_torch.layers  # noqa: F401
    import paddle_tpu_torch.layers.distributions  # noqa: F401
    import paddle_tpu_torch.metrics  # noqa: F401
    import paddle_tpu_torch.nets  # noqa: F401
    import paddle_tpu_torch.observability  # noqa: F401
    import paddle_tpu_torch.optimizer  # noqa: F401
    import paddle_tpu_torch.regularizer  # noqa: F401
    import paddle_tpu_torch.resilience  # noqa: F401
    import paddle_tpu_torch.serving  # noqa: F401
    import paddle_tpu_torch.tools.ckpt_doctor  # noqa: F401
    import paddle_tpu_torch.tuning  # noqa: F401
    import paddle_tpu_torch.utils.checkpointer  # noqa: F401
    import paddle_tpu_torch.warmstore  # noqa: F401
    return {n: sys.modules[n] for n in MODULES if n not in NOT_PORTED}


#: modules of the list the port does not have yet, with the reason
NOT_PORTED = {
    "paddle_tpu_torch.comm": "ROADMAP item 13 (quantized collectives, the reshard planner)",
    "paddle_tpu_torch.online": "ROADMAP item 13 (online table publishing)",
}


def reference_name(path: str) -> str:
    """A port path under the JAX package's name."""
    if path.startswith(PORT + ".tools."):
        return path[len(PORT) + 1:]
    return REFERENCE + path[len(PORT):]


def port_name(path: str) -> str:
    """A JAX package path (``tests/api_spec.txt``) under the port's name."""
    if path.startswith("tools."):
        return f"{PORT}.{path}"
    if path.startswith(REFERENCE + "."):
        return PORT + path[len(REFERENCE):]
    raise ValueError(f"{path!r} is not a path of {REFERENCE} or tools")


def _signature(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def iter_api():
    mods = _imported()
    for modname in MODULES:
        if modname in NOT_PORTED:
            continue
        mod = mods[modname]
        for name in sorted(dir(mod)):
            if name.startswith("_"):
                continue
            obj = getattr(mod, name)
            if inspect.ismodule(obj):
                continue
            # only symbols that belong to the port (not re-exported numpy etc.)
            owner = getattr(obj, "__module__", "") or ""
            if owner.split(".")[0] != PORT:
                continue
            if inspect.isclass(obj):
                yield f"{modname}.{name} class{_signature(obj)}"
                for mname, m in sorted(vars(obj).items()):
                    if mname.startswith("_") or not callable(m):
                        continue
                    yield (f"{modname}.{name}.{mname} "
                           f"method{_signature(m)}")
            elif callable(obj):
                yield f"{modname}.{name} def{_signature(obj)}"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--as-reference", action="store_true",
                    help="print paths under the JAX package's names")
    args = ap.parse_args(argv)
    for modname, why in NOT_PORTED.items():
        print(f"print_signatures: {modname} skipped: {why}", file=sys.stderr)
    for line in sorted(set(iter_api())):
        if args.as_reference:
            path, rest = line.split(" ", 1)
            line = f"{reference_name(path)} {rest}"
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
