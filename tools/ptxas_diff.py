"""Compare the ptxas report of every kernel instance between two kernel
build directories (``esr_tpu_torch/ops/cuda/.torch_kernels_build`` of two
checkouts, each built by ``lib.build_all()``, whose ``.log`` files hold
nvcc's ``-Xptxas -v`` output):

    python tools/ptxas_diff.py PARENT_BUILD_DIR CHANGE_BUILD_DIR

Prints, per library and mangled kernel name, the stack / spill line and
the registers line of each instance that differs, is new or is gone, and a
count of those that are the same. Exit code 1 if any instance in both
differs."""

import re
import sys
from pathlib import Path


def report(build_dir: str) -> dict:
    out = {}
    for log in sorted(Path(build_dir).glob("*.log")):
        lines, lib = log.read_text().splitlines(), log.name.split("-")[0]
        for i, ln in enumerate(lines):
            m = re.search(r"Function properties for (\S+)", ln)
            if m:
                used = next((x for x in lines[i + 1:i + 4] if "Used" in x), "")
                out[(lib, m[1])] = (lines[i + 1].strip(), used.replace("ptxas info    :", "").strip())
    return out


def main(argv=None) -> int:
    a, b = (report(d) for d in (argv or sys.argv[1:])[:2])
    differ = [k for k in a if k in b and a[k] != b[k]]
    print(f"instances: {len(a)} and {len(b)}; the same {sum(k in b and a[k] == b[k] for k in a)}, "
          f"differ {len(differ)}, new {sum(k not in a for k in b)}, gone {sum(k not in b for k in a)}")
    for k in differ:
        print(f"differs {k[0]} {k[1]}\n  {' | '.join(a[k])}\n  {' | '.join(b[k])}")
    for k in (k for k in b if k not in a):
        print(f"new {k[0]} {k[1]}: {' | '.join(b[k])}")
    for k in (k for k in a if k not in b):
        print(f"gone {k[0]} {k[1]}")
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
