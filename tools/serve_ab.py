"""The serve cell's one-shot run (``chip_smoke.phase_serve``: qwen2-1.5b at
full width and depth, 8 requests, 32 generated tokens each) on the
checkout at ROOT, four times in one process; prints the host-clock
seconds of the decode steps and of the whole run for the last three.  To
compare two trees on one card, unpack the parent with ``git archive``
into a directory that .gitignore lists and run parent, change, change,
parent in one command on a machine with the card:

  for r in build/parent . . build/parent; do python tools/serve_ab.py $r; done
"""

from __future__ import annotations

import sys
from pathlib import Path

root = str(Path(sys.argv[1]).resolve())
sys.path[:0] = [root + "/src", root]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.policy import AccumulationPolicy, plan_for_model  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.models.api import get_model  # noqa: E402


def _bf16(tree):
    if isinstance(tree, dict):
        return {k: _bf16(v) for k, v in tree.items()}
    return tree.to(torch.bfloat16)


def main() -> None:
    build.build_all(["qgemm", "paged_decode", "paged_prefill"])
    dev = torch.device("cuda")
    cfg = plan_for_model(get_config("qwen2-1.5b"),
                         seq_len=max(cs.PROMPT_LENS) + cs.GEN,
                         global_batch=len(cs.PROMPT_LENS),
                         policy=AccumulationPolicy(mode="predicted", chunk=64))
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    params = _bf16(get_model(cfg).init_params(gen, dev))
    rng = np.random.RandomState(cs.SEED + 1)
    prompts = [rng.randint(0, cfg.vocab_size, n).tolist()
               for n in cs.PROMPT_LENS]
    runs = [cs.phase_serve(cfg, params, dev, prompts, None) for _ in range(4)]
    print(f"serve {root}: decode steps / whole run, s: "
          + ", ".join(f"{r['decode_s']:.3f}/{r['seconds']:.3f}"
                      for r in runs[1:]), flush=True)


if __name__ == "__main__":
    main()
