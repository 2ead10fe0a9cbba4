"""Count each CUDA kernel's machine instructions, and its FP64 ones.

    python3 tools/torch_kernel_sass.py [--match biquad] [--dump FILE]

Builds the port's kernel library (``ops/cuda_build.py``) if needed,
disassembles it with ``cuobjdump -sass`` and prints one JSON line per
kernel function whose name contains ``--match`` (all of them by default):
its SASS instruction count, its FP64 instructions (``DADD``, ``DMUL``,
``DFMA``, ``DSETP``, conversions to or from F64) by opcode, and the
``ptxas -v`` lines of the build (each kernel's entry, registers and
spills), when this process built the library. ``--dump`` writes the
whole disassembly to a file.
Needs the CUDA toolkit, so it runs on the card's machine.
"""

from __future__ import annotations

import argparse
import collections
import json
import re
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from webrtc_audio_processing_tpu_torch.ops import cuda_build  # noqa: E402

FP64_OPS = {"DADD", "DMUL", "DFMA", "DSETP", "DSET", "DMNMX"}
_INSN = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)")


def is_fp64(opcode: str) -> bool:
    base = opcode.split(".")[0]
    return base in FP64_OPS or ("F64" in opcode and base in {
        "F2F", "I2F", "F2I", "FRND"})


def kernels(sass: str):
    """{function name: Counter of opcodes} from cuobjdump's listing."""
    out, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            out[name] = collections.Counter()
        elif name is not None:
            m = _INSN.search(line)
            if m:
                out[name][m.group(1)] += 1
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--match", default="")
    parser.add_argument("--dump", default=None)
    args = parser.parse_args(argv)
    lib = cuda_build.library()
    cuobjdump = Path(cuda_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib.path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    if args.dump:
        Path(args.dump).parent.mkdir(parents=True, exist_ok=True)
        Path(args.dump).write_text(sass)
    ptxas = cuda_build.ptxas_lines(lib.log)
    for name, ops in kernels(sass).items():
        if args.match not in name:
            continue
        fp64 = {op: n for op, n in sorted(ops.items()) if is_fp64(op)}
        print(json.dumps({"kernel": name,
                          "instructions": sum(ops.values()),
                          "fp64": sum(fp64.values()), "fp64_ops": fp64}))
    print(json.dumps({"library": lib.path.name, "ptxas": ptxas}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
