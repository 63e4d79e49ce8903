"""Launcher target for tests/test_torch_parallel_cli.py: the port's CLI with
the prediction renderer recorded. Each render appends the process's rank
and the panel prefix to ``$VIZ_RECORD.rank<r>``, then draws as usual.

Usage: python -m torch.distributed.run ... tests/_viz_rank.py train ...
"""

import json
import os

import dquartic_tpu_torch.utils.viz as viz
from dquartic_tpu_torch.cli import main

_draw = viz.plot_single_prediction


def _recorded(*arrays, **kwargs):
    rank = os.environ.get("RANK", "0")
    with open(f"{os.environ['VIZ_RECORD']}.rank{rank}", "a") as f:
        f.write(json.dumps({"rank": int(rank), "prefix": kwargs.get("prefix")}) + "\n")
    return _draw(*arrays, **kwargs)


viz.plot_single_prediction = _recorded

if __name__ == "__main__":
    main()
