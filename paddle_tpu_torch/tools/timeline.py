"""Chrome-trace timeline tool (the port's copy of the JAX package's
``tools/timeline.py``; reference tools/timeline.py:36).

Convert a ``fluid.profiler`` session's capture into chrome://tracing /
Perfetto JSON, the flight recorder's spans spliced in on the trace's clock
(``profiler.export_chrome_tracing``):

    python -m paddle_tpu_torch.tools.timeline --trace_dir /tmp/my_trace \\
        --timeline_path out.json

Merge several processes' captures with disjoint pids (the reference's
``--profile_path a,b,c``):

    python -m paddle_tpu_torch.tools.timeline \\
        --profile_path rank0.json,rank1.json.gz --timeline_path merged.json

A ``trace_dir`` is read from disk; the flight recorder's spans are this
process's, so a timeline written in another process than the session's
carries the session's trace alone.
"""
import argparse
import sys

from .. import profiler


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m paddle_tpu_torch.tools.timeline",
                                 description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--trace_dir", default=None,
                    help="directory passed to fluid.profiler.profiler(trace_dir=...)")
    ap.add_argument("--profile_path", default=None,
                    help="comma-separated chrome trace files (.json/.json.gz) to merge "
                         "with disjoint pids")
    ap.add_argument("--timeline_path", default="timeline.json")
    args = ap.parse_args(argv)
    if args.profile_path:
        out = profiler.merge_chrome_traces(
            [p for p in args.profile_path.split(",") if p], args.timeline_path)
    elif args.trace_dir:
        out = profiler.export_chrome_tracing(args.trace_dir, args.timeline_path)
    else:
        ap.error("pass --trace_dir or --profile_path")
    print(f"wrote {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
