"""The worst case of AGC1's limiter loop over AGC1's configuration range.

The loop of ``ops/cuda_agc1_limiter.py`` lowers a subframe's gain by
-0.1 dB a pass until envelope x gain^2 is below full scale (with the
reference's int32 arithmetic, products that wrap included). Its length
depends on the gain and the envelope. This script counts the passes for
every gain of every gain table AGC1 can build:

- fixed digital: compression 0..90 dB plus target 0..31 dBFS;
- adaptive analog and digital: compression 0..90, target 0..31, the
  analog target the config derives;
- the hybrid AgcManagerDirect's tables, compression 0..18;

on the envelopes 2^k - 1 and 2^k for k = 0..30 (full scale is 2^30).
It prints one JSON line: the most passes, where they occur, and how many
(table, gain, envelope) cases need none.

    python3 tools/torch_agc1_limiter_worst.py      # CPU, ~1 min
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from webrtc_audio_processing_tpu_torch.models.agc1 import (  # noqa: E402
    analog,
    digital,
)
from webrtc_audio_processing_tpu_torch.ops import (  # noqa: E402
    cuda_agc1_limiter as lim,
)


def tables():
    """(label, table) for every configuration of the range."""
    for mode in (digital.AGC_MODE_FIXED_DIGITAL,
                 digital.AGC_MODE_ADAPTIVE_ANALOG):
        for comp in range(91):
            for target in range(32):
                cfg = analog.LegacyAgcConfig(agc_mode=mode,
                                             compression_gain_db=comp,
                                             target_level_dbfs=target)
                yield (f"mode {mode} comp {comp} target {target}",
                       cfg.gain_table)
    for comp in range(19):
        yield (f"hybrid comp {comp}",
               digital.calculate_gain_table(comp, 2, True, comp))


def main():
    gains = {}
    for label, tab in tables():
        for g in np.unique(tab):
            if int(g) not in gains:
                gains[int(g)] = label
    g_all = np.array(sorted(gains), np.int64)
    envs = np.unique(np.array([max(0, (1 << k) - d) for k in range(31)
                               for d in (0, 1)], np.int64))
    G = torch.tensor(np.repeat(g_all, len(envs)), dtype=torch.int32)
    E = torch.tensor(np.tile(envs, len(g_all)), dtype=torch.int32)
    _, passes = lim._loop(G, E)
    i = int(torch.argmax(passes))
    gi, ei = int(G[i]), int(E[i])
    print(json.dumps({
        "tables": sum(1 for _ in tables()), "distinct_gains": len(g_all),
        "envelopes": len(envs), "worst_passes": int(passes[i]),
        "worst_gain": gi, "worst_envelope": ei,
        "worst_table": gains[gi],
        "cases_with_no_pass": int((passes == 0).sum()),
        "cases": int(passes.numel()),
    }))


if __name__ == "__main__":
    main()
