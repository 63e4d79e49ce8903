#!/usr/bin/env python3
"""Time the port's async sharded checkpoint backend (``tpu.checkpoint_backend:
"orbax"``) at full width with a given optimizer and EMA, on one CUDA card.

    python3 scripts/time_async_ckpt_torch.py [--optimizer adamw] [--ema 0.999]

It builds the kernels (``chip_smoke.phase_info``), then runs
``chip_smoke.phase_async_ckpt`` on the canonical config
(``dquartic_train_config.json``, 1.205 B parameters, bf16 on float32
masters, fused kernels): one epoch of two steps writing latest and best,
the ms each save held the training thread, the background write and the
final wait, a warm save, the msgpack path's ``_save`` of the same state,
and a resume into a trainer of another seed held bitwise. With AdamW and
an EMA the state is about 19.3 GB a save (``chip_smoke.py`` phase 15 runs
the factored optimizer without an EMA, about 5 GB). It prints the card's
name and power limit, and the measurements as one JSON line. It needs
twice the state in free disk under the temporary directory.
"""

import argparse
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "factored"])
    ap.add_argument("--ema", type=float, default=0.999, help="EMA decay (0: none)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("time_async_ckpt_torch: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import chip_smoke as cs

    from dquartic_tpu_torch.utils.config import load_train_config

    cs.phase_info()
    config = load_train_config(cs.CONFIG)
    config["wandb"]["use_wandb"] = False
    config["tpu"].update(linear_attn_impl="pallas_t")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    out = cs.phase_async_ckpt(config, args.seed, gen, {}, optimizer=args.optimizer,
                              ema=args.ema or None)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
