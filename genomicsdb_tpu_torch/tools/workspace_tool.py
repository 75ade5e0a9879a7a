"""Workspace CLI: create / consolidate / list arrays.

Equivalents of tools/src/create_tiledb_workspace.cc and
consolidate_tiledb_array.cc.

Usage:
  python -m genomicsdb_tpu_torch.tools.workspace_tool create <workspace>
  python -m genomicsdb_tpu_torch.tools.workspace_tool consolidate <workspace> <array>
  python -m genomicsdb_tpu_torch.tools.workspace_tool list <workspace>
"""

from __future__ import annotations

import os
import sys

from ..store import workspace as ws


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if argv[:1] in (["-h"], ["--help"]):
        print(__doc__)
        return 0
    if not argv:
        sys.stderr.write(__doc__)
        return 2
    cmd = argv[0]
    if cmd == "create" and len(argv) == 2:
        ws.create_workspace(argv[1])
        return 0
    if cmd == "consolidate" and len(argv) == 3:
        ws.consolidate_array(argv[1], argv[2])
        return 0
    if cmd == "list" and len(argv) == 2:
        if not ws.is_workspace(argv[1]):
            sys.stderr.write(f"{argv[1]} is not a workspace\n")
            return 1
        for name in sorted(os.listdir(argv[1])):
            d = os.path.join(argv[1], name)
            if os.path.isdir(d):
                frags = [f for f in os.listdir(d) if f.endswith(".npz")]
                print(f"{name}\t{len(frags)} fragment(s)")
        return 0
    sys.stderr.write(__doc__)
    return 2


if __name__ == "__main__":
    sys.exit(main())
