"""Time forms of K6 (the AEC3 subtractor pair kernel) against each other on
the card, in turns.

    python3 tools/torch_k6_variants.py [--source FILE] [--out DIR]

Builds forms of a K6 source (by default ``csrc/subtractor.cu``), each
with one part changed, each into its own shared library (one ``nvcc`` each,
all at once, the package's flags), and calls them through the package's C
signature (``cuda_subtractor.launch_args``). A form whose anchor text is not
in the source is reported as not applicable and skipped, so the same script
times the forms of the kernel before and after its redesign:

- ``kept``: the source as it is.

Forms of the direct-sum kernel (before the redesign):

- ``one_term`` (timing only): every 128-point transform cut to one term of
  its direct sum, which bounds what the transforms cost;
- ``regs64``: ``__launch_bounds__`` asks for 4 blocks of 256 threads an
  SM, which caps a thread at 64 registers;
- ``window_once`` (timing only): the render window and its spectral sums
  loaded for the frame's first block only, which bounds what staging the
  window once per frame can save;
- ``float_tables``: the twiddle and Hann tables computed in float, not in
  double.

Forms of the FFT kernel (after it):

- ``one_stage_fft`` (timing only): each 64-point FFT cut to its in-register
  stage and one stage across lanes, which bounds what the transforms cost;
- ``per_block_window``: every block loads its own window rows, never the
  staged span (must pass the bar and equal ``kept`` bit for bit);
- ``r1_256_threads``: one render channel on 256 threads (3 blocks an SM)
  in place of 128 (5 blocks an SM);
- ``phase_clocks`` (timing only): thread 0 of each block reads the SM's
  clock at every barrier of the block loop and writes the cycles each
  phase took, summed over the frame's blocks, and the prologue's, in place
  of its first error output; the tool prints their means over the
  launch's blocks;
- ``adapt_unrolled``: the adapt sweep's loop unrolled by 4;
- ``no_apply``, ``no_adapt``, ``no_responses`` (timing only): the
  filters' products, the adapt sweep of the partitions not constrained, or
  the impulse- and frequency-response phase skipped, each a bound on what
  its phase costs;
- ``no_block_outputs`` (timing only): the per-block frequency and impulse
  responses not written to device memory.

- ``all_cuts`` (timing only): all the forms that apply at once.

At ``48k_stereo_nb3`` (B = 2048) and ``16k_mono_nb3`` (B = 4096), the
inputs of ``chip_smoke.k6_inputs``, each form is held against the plain twin
with ``chip_smoke.k6_compare`` (a form that is not timing only must pass
K6's bar) and against ``kept`` bit for bit (reported), then device-timed
by CUDA-graph replay (5 calls a graph, 5 replays), the forms in turns
(order, then reversed, three times). Prints the card's name and power
limit, each form's ptxas lines, one JSON line per check and one per shape
with each form's median and its six times. Needs the CUDA toolkit, so it
runs on the card's machine.
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

import chip_smoke  # noqa: E402
from webrtc_audio_processing_tpu_torch.ops import (  # noqa: E402
    cuda_build,
    cuda_subtractor,
)

# Each form: (timing only, [(anchor, replacement), ...]). The anchors of the
# direct-sum kernel and of the FFT kernel differ; a form applies where all
# of its anchors are found.
FORMS = {
    "one_term": (True, [
        ("for (int k = 1; k < kBins - 1; ++k) {",
         "for (int k = 1; k < 2; ++k) {"),
        ("for (int n = 0; n < kBlock; ++n) {\n    const int j = (k * (n",
         "for (int n = 0; n < 1; ++n) {\n    const int j = (k * (n"),
    ]),
    "one_stage_fft": (True, [
        ("for (int d = 16; d >= 1; d >>= 1) {  // FFT stages",
         "for (int d = 16; d >= 16; d >>= 1) {  // FFT stages"),
        ("for (int d = 1; d <= 16; d <<= 1) {  // FFT stages",
         "for (int d = 1; d <= 1; d <<= 1) {  // FFT stages"),
    ]),
    "per_block_window": (False, [
        ("  bool staged = true;\n", "  bool staged = false;\n"),
    ]),
    "r1_256_threads": (False, [
        ("return R == 1 ? launch<128, 5>(", "return R == 1 ? launch<256, 3>("),
    ]),
    "phase_clocks": (True, [
        ("  const Shared s = carve(",
         "  const long long clk_start = clock64();\n"
         "  const Shared s = carve("),
        ("  cp_async_wait_all();\n  __syncthreads();\n",
         "  cp_async_wait_all();\n  __syncthreads();\n"
         "  long long clk_last = clock64(), clk_ph[8] = {0};\n"
         "  clk_ph[7] = clk_last - clk_start;\n  int clk_n = 0;\n"),
        ("    const bool delay_change = ev[1] != 0;\n",
         "    const bool delay_change = ev[1] != 0;\n    clk_n = 0;\n"),
        ("\n    __syncthreads();\n",
         "\n    __syncthreads();\n    {\n      const long long t = clock64();\n"
         "      clk_ph[clk_n++ % 7] += t - clk_last;\n      clk_last = t;\n"
         "    }\n"),
        ("  if (tid == 0) {\n    float* fso = a.fs_o",
         "  if (tid == 0) {\n    float* dbg = a.e_ref + (size_t)b * nb * C * "
         "kBlock + c * kBlock;\n    for (int i = 0; i < 8; ++i) dbg[i] = "
         "(float)clk_ph[i];\n  }\n  if (tid == 0) {\n    float* fso = a.fs_o"),
    ]),
    "adapt_unrolled": (False, [
        ("#pragma unroll 1\n      for (int i = tid - kStride; i < n;",
         "#pragma unroll 4\n      for (int i = tid - kStride; i < n;"),
    ]),
    "no_apply": (True, [
        ("        for (int p = 0; p < size; ++p) {\n"
         "          const int x = (xb + p) * L + l;",
         "        for (int p = 0; p < 0; ++p) {\n"
         "          const int x = (xb + p) * L + l;"),
    ]),
    "no_adapt": (True, [
        ("      for (int i = tid - kStride; i < n; i += kStride) {",
         "      for (int i = tid - kStride; i < 0; i += kStride) {"),
    ]),
    "no_responses": (True, [
        ("      for (int i = tid; i < P * kBlock; i += NT) {\n        float v;",
         "      for (int i = tid; i < 0; i += NT) {\n        float v;"),
        ("      for (int i = tid; i < P * kBins; i += NT) {\n"
         "        const int p = i / kBins;",
         "      for (int i = tid; i < 0; i += NT) {\n"
         "        const int p = i / kBins;"),
    ]),
    "no_block_outputs": (True, [
        ("        oimp[i] = v;\n", "        (void)v;\n"),
        ("        ofreq[i] = m;\n", ""),
    ]),
    "regs64": (False, [
        ("__global__ void __launch_bounds__(kThreads)",
         "__global__ void __launch_bounds__(kThreads, 4)"),
    ]),
    "window_once": (True, [
        ("    for (int i = tid; i < P * L; i += kThreads) {\n"
         "      const int p = i / L;",
         "    if (kb == 0) for (int i = tid; i < P * L; i += kThreads) {\n"
         "      const int p = i / L;"),
        ("    for (int k = tid; k < kBins; k += kThreads) {\n"
         "      float sr = 0.0f, sc = 0.0f;",
         "    if (kb == 0) for (int k = tid; k < kBins; k += kThreads) {\n"
         "      float sr = 0.0f, sc = 0.0f;"),
    ]),
    "float_tables": (False, [
        ("    double s, co;\n    sincospi(j / 64.0, &s, &co);",
         "    float s, co;\n    sincospif(j / 64.0f, &s, &co);"),
        ("const double w = sin(kPi * n / 63.0);",
         "const float w = sinpif(n / 63.0f);"),
    ]),
}
SHAPES = ("48k_stereo_nb3", "16k_mono_nb3")


def forms(src: str):
    """{name: (timing only, source)}; the names of forms that do not
    apply."""
    out, skipped, cuts = {"kept": (False, src)}, [], src
    for name, (timing, edits) in FORMS.items():
        if not all(a in src for a, _ in edits):
            skipped.append(name)
            continue
        body = src
        for a, b in edits:
            body = body.replace(a, b)
            cuts = cuts.replace(a, b)
        out[name] = (timing, body)
    if len(out) > 2:
        out["all_cuts"] = (True, cuts)
    return out, skipped


def build(out: Path, bodies):
    """{form: the loaded C entry point}; prints each form's ptxas lines."""
    out.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_build._nvcc()
    procs = {}
    for name, (_, src) in bodies.items():
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
        fn = ctypes.CDLL(str(out / f"{name}.so")).subtractor_pair_f32
        fn.argtypes = list(cuda_build._SIGNATURES["subtractor_pair_f32"])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def caller(fn, inp):
    """A no-argument launch of ``fn`` on ``inp`` into its own outputs."""
    config, _, *rest = inp.values()
    args, result, held = cuda_subtractor.launch_args(config, *rest)
    st = rest[0]

    def call():
        cuda_build.check(fn(*args, cuda_build.raw_stream(st.H)),
                         "subtractor_pair_f32")
    call.held = held  # the inputs the pointers point into
    return call, result


def worst_leaf(got, want):
    """(name, relative error, stream) of the float leaf farthest from the
    twin relative to its scale."""
    worst = (None, 0.0, None)
    for (name, g), (_, w) in zip(chip_smoke.k6_leaves(got),
                                 chip_smoke.k6_leaves(want)):
        if not w.dtype.is_floating_point:
            continue
        d = (g.double() - w.double()).abs().reshape(g.shape[0], -1)
        rel = float(d.max()) / max(float(w.abs().max()), 1e-3)
        if rel > worst[1]:
            worst = (name, rel, int(d.max(dim=1).values.argmax()))
    return worst


def graph_ms(call, n=5, replays=5):
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--source", default=str(cuda_build.CSRC / "subtractor.cu"),
                    help="the K6 source whose forms are timed")
    ap.add_argument("--out", default=str(cuda_build.BUILD_DIR / "k6_forms"),
                    help="where the forms' sources and libraries go")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    bodies, skipped = forms(Path(args.source).read_text())
    print(json.dumps({"source": args.source, "not_applicable": skipped}))
    fns = build(Path(args.out), bodies)
    dev = torch.device("cuda")
    ok = True
    for shape in SHAPES:
        case = chip_smoke.K6_CASES[shape]
        seed = chip_smoke.SEED + list(chip_smoke.K6_CASES).index(shape)
        inp = chip_smoke.k6_inputs(*case[:5], seed=seed, device=dev,
                                   below_gate=case[5])
        config, geo, *rest = inp.values()
        want = cuda_subtractor.pair_plain(config, geo, *rest)
        calls, kept = {}, None
        for name, fn in fns.items():
            call, got = caller(fn, inp)
            call()
            torch.cuda.synchronize()
            rel, err, bad, splits = chip_smoke.k6_compare(got, want)
            leaves = [t for _, t in chip_smoke.k6_leaves(got)]
            kept = leaves if kept is None else kept
            same = all(torch.equal(a, b) for a, b in zip(leaves, kept))
            timing = bodies[name][0]
            passed = rel <= chip_smoke.K6_RTOL and not bad
            ok = ok and (timing or passed)
            if name == "phase_clocks":
                cycles = got[1].e_refined[:, 0, :, :8].double()
                print(json.dumps({"shape": shape, "form": name,
                                  "mean_cycles_per_phase": cycles.mean(
                                      dim=(0, 1)).tolist()}))
            print(json.dumps({"shape": shape, "form": name,
                              "timing_only": timing, "max_rel": rel,
                              "worst_leaf": worst_leaf(got, want),
                              "max_abs": err, "failing_leaves": bad,
                              "tie_splits": splits, "passes_bar": passed,
                              "bit_equal_to_kept": same}), flush=True)
            calls[name] = (call, got)
        times = {name: [] for name in calls}
        order = list(calls)
        for _ in range(3):
            for name in order + order[::-1]:
                times[name].append(graph_ms(calls[name][0]))
        print(json.dumps({"shape": shape, "device_ms": {
            name: {"median": float(np.median(t)), "all": t}
            for name, t in times.items()}}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
