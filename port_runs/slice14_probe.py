"""Phase 18 of chip_smoke.py (``slice14_phases``) alone on the card, after
the set-up it needs from phases 2, 7 and 10: the kernels built, phase 7's
flagship decoder and its output, phase 10's synthetic training files.
Prints phase 18's JSON lines, the launch counts by path, and the seconds.

    python3 port_runs/slice14_probe.py
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from koemorph_tpu_torch.models import dual_stream_model as dm  # noqa: E402
from koemorph_tpu_torch.ops import cuda as ck  # noqa: E402
from koemorph_tpu_torch.parallel import BatchedSequentialDecoder  # noqa
from koemorph_tpu_torch.train.__main__ import (  # noqa: E402
    write_synthetic_dataset)


def main() -> int:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    print(sys.version, torch.__version__, torch.version.cuda, flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    card = f"{torch.cuda.get_device_name(0)}, {smi.split(',')[-1].strip()}"
    print(smi, flush=True)
    ck.build()
    work = ROOT / "build" / "chip_smoke"
    work.mkdir(parents=True, exist_ok=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    audio_b = np.stack([cs.voiced_audio(cs.DECODE_LEN / cs.SR, seed=s)
                        for s in range(1, cs.DECODE_B + 1)])
    model = dm.SequentialDualStreamModel(
        d_model=256, num_heads=8, mel_sequence_length=256, target_fps=30,
        stride_frames=cs.DECODE_STRIDE, window_edge="reflect")
    model.init_random(torch.Generator().manual_seed(0))
    decoder = BatchedSequentialDecoder(model)
    audio_dev = torch.from_numpy(audio_b).to("cuda")
    decoder(audio_dev)
    out_np = decoder(audio_dev).cpu().numpy()
    synth = write_synthetic_dataset(work / "train_synth", 2, duration_s=36.0)
    print("setup", time.perf_counter() - t0, flush=True)
    s14 = cs.slice14_phases(card, work, env, decoder, out_np, audio_b, synth)
    print("shapes", {k: {f"{a}{list(b)}": v for (a, b), v in d.items()}
                     for k, d in s14["shapes"].items()}, flush=True)
    print("total", time.perf_counter() - t0, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
