"""Time K3's design variants against each other on the card, in turns.

    python3 tools/torch_k3_variants.py [--out DIR]

Builds four forms of the matched-filter NLMS bank, each from one source
into its own shared library (one ``nvcc`` each, all at once, the package's
flags), and calls them through the package's C signature:

- ``kept``: ``csrc/matched_filter.cu`` as built into the package (one warp
  per (stream, filter), each warp loading its own segment);
- ``kept_runtime_sub``: the same without its taps 512 / sub 16
  specialisation, so that shape runs the runtime-sub form ``<16, 0>``;
- ``staged`` and ``staged_runtime_sub``: ``tools/torch_k3_staged.cu``, which
  stages each stream's ring span once per block, with and without the
  specialisation.

At the path's shape (B = 2048, 5 filters of 512 taps, sub 16, DS = 2448,
shift 384) and at taps 256 / sub 8, each form is held against the plain
twin at K3's bar (h, alphas, err within 2e-5 max-relative; updated and
segs exact) and against ``kept`` bit for bit, then device-timed by
CUDA-graph replay (20 calls a graph, 5 replays), the forms in turns
(1..4, 4..1, three times). Prints the card's name and power limit, one
JSON line per check and one per shape with each form's median and its six
times. Needs the CUDA toolkit, so it runs on the card's machine.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from webrtc_audio_processing_tpu_torch.ops import (  # noqa: E402
    cuda_build,
    cuda_matched_filter,
)

B, N, DS, SHIFT = 2048, 5, 2448, 384
SPEC = "  if (taps == 512 && sub == 16) return WAP_NLMS(16, 16);\n"


def sources():
    kept = (cuda_build.CSRC / "matched_filter.cu").read_text()
    staged = (ROOT / "tools" / "torch_k3_staged.cu").read_text()
    for src in (kept, staged):
        if SPEC not in src:
            raise RuntimeError("the specialisation's dispatch line moved")
    return {"kept": kept, "kept_runtime_sub": kept.replace(SPEC, ""),
            "staged": staged, "staged_runtime_sub": staged.replace(SPEC, "")}


def build(out: Path):
    """{form: the loaded C entry point}; prints each form's ptxas lines."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build._nvcc()
    procs = {}
    for name, src in sources().items():
        cu = out / f"{name}.cu"
        cu.write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *cuda_build.NVCC_FLAGS, "-shared", str(cu), "-o",
             str(out / f"{name}.so")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        print(json.dumps({"form": name,
                          "ptxas": cuda_build.ptxas_lines(log)}))
        fn = ctypes.CDLL(str(out / f"{name}.so")).matched_filter_nlms_f32
        fn.argtypes = list(cuda_build._SIGNATURES["matched_filter_nlms_f32"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def inputs(taps, sub, seed, dev):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    low = rng.standard_normal((B, DS)).astype(f32) * 400
    lr = rng.integers(0, DS, B).astype(np.int32)
    h0 = rng.standard_normal((B, N, taps)).astype(f32) * 0.01
    y = rng.standard_normal((B, sub)).astype(f32) * 400
    sm = np.full((B,), 0.7, f32)
    return [torch.from_numpy(a).to(dev) for a in (low, lr, h0, y, sm)]


def caller(fn, ins, threshold):
    """A no-argument launch of ``fn`` on ``ins`` into its own outputs."""
    low, lr, h0, y, sm = ins
    taps, sub = h0.shape[2], y.shape[1]
    dev = h0.device
    outs = (torch.empty_like(h0), torch.empty((B, N, sub), device=dev),
            torch.empty((B, N), device=dev),
            torch.empty((B, N), dtype=torch.uint8, device=dev),
            torch.empty((B, N, sub - 1 + taps), device=dev))
    ptrs = [t.data_ptr() for t in (*ins, *outs)]

    def call():
        cuda_build.check(fn(*ptrs, B, N, SHIFT, DS, threshold, sub, taps,
                            cuda_build.raw_stream(h0)),
                         "matched_filter_nlms_f32")
    return call, outs


def graph_ms(call, n=20, replays=5):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            call()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (n * replays)


def max_rel(got, want):
    want = want.double()
    return float((got.double() - want).abs().max()
                 / (want.abs().max() + 1e-30))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=str(cuda_build.BUILD_DIR / "k3_forms"),
                    help="where the forms' sources and libraries go")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    fns = build(Path(args.out))
    dev = torch.device("cuda")
    ok = True
    for taps, sub in ((512, 16), (256, 8)):
        shape = f"taps{taps}_sub{sub}"
        ins = inputs(taps, sub, 7 + taps + sub, dev)
        threshold = taps * 150.0 ** 2
        want = cuda_matched_filter.nlms_plain(
            *ins, shift=SHIFT, ds_size=DS, threshold=threshold)
        calls, kept, held = {}, None, []
        for name, fn in fns.items():
            call, outs = caller(fn, ins, threshold)
            call()
            torch.cuda.synchronize()
            rel = max(max_rel(g, w) for g, w in zip(outs[:3], want[:3]))
            exact = (torch.equal(outs[3].bool(), want[3])
                     and torch.equal(outs[4], want[4]))
            kept = outs if kept is None else kept
            same = all(torch.equal(a, b) for a, b in zip(outs, kept))
            ok = ok and rel <= 2e-5 and exact and same
            print(json.dumps({"shape": shape, "form": name, "max_rel": rel,
                              "updated_segs_exact": exact,
                              "bit_equal_to_kept": same}))
            calls[name] = call
            held.append(outs)  # the launches write into these
        times = {name: [] for name in calls}
        order = list(calls)
        for _ in range(3):
            for name in order + order[::-1]:
                times[name].append(graph_ms(calls[name]))
        print(json.dumps({"shape": shape, "device_ms": {
            name: {"median": float(np.median(t)), "all": t}
            for name, t in times.items()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
