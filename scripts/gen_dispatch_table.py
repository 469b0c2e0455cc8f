"""Render the backend-dispatch matrix from the live dispatch function.

The README's "Dispatch semantics" table is this script's output, and
tests/test_dispatch.py asserts the same cells against
`parallel/batch.py::dispatch_decision` — one source of truth, so docs, tests,
and the dispatcher cannot drift apart. Regenerate with:

    python scripts/gen_dispatch_table.py
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

os.environ.setdefault("JAX_PLATFORMS", "cpu")


def main():
    from gpmpc_tpu.parallel.batch import dispatch_decision

    rows = [
        ("GPU, backend auto (the default)", "auto", "gpu", False, False),
        ("GPU, backend lanes", "lanes", "gpu", False, False),
        ("GPU, per-scenario GP population", "auto", "gpu", False, True),
        ("GPU, backend xla", "xla", "gpu", False, False),
        ("CPU, backend auto (the default)", "auto", "cpu", False, False),
        ("CPU, backend lanes", "lanes", "cpu", False, False),
        ("CPU, interpret=True", "auto", "cpu", True, False),
        ("CPU, backend xla", "xla", "cpu", False, False),
    ]
    print("| Requested configuration | Path taken | Interpret | Why |")
    print("|---|---|---|---|")
    for label, backend, platform, interpret, gpb in rows:
        d = dispatch_decision(backend, platform, interpret, gpb)
        print(f"| {label} | `{d.path}` | {d.interpret} | {d.reason} |")
    print("| any other platform | error | | `ValueError`: unsupported platform |")


if __name__ == "__main__":
    main()
