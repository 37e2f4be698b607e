"""``repro_torch.launch.train``'s ``main`` on this script's arguments,
with the arch's config in float32, the precision the launcher tests
compare in (the launcher trains in the config's own dtype):

  python tests/torch_launch_float32.py --arch qwen2-1.5b --device cpu
  python -m torch.distributed.run --standalone --nproc-per-node 4 \\
      tests/torch_launch_float32.py --mesh 2x1x2 --device cpu
"""

import dataclasses
import sys

import torch

from repro_torch.launch import train

_config = train.get_config


def float32_config(*args, **kwargs):
    return dataclasses.replace(_config(*args, **kwargs), dtype=torch.float32)


if __name__ == "__main__":
    train.get_config = float32_config
    train.main(sys.argv[1:])
