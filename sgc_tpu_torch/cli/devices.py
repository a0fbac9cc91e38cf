"""Device probe (the counterpart of sgc_tpu/cli/devices.py): prints the
torch and CUDA versions and every CUDA device (name, compute capability,
memory), then runs one 128 x 128 matmul on the chosen device, the card by
default. Without a card and without ``--device cpu`` it exits 1.

    python -m sgc_tpu_torch.cli.devices [--device cpu]
"""

from __future__ import annotations

import argparse
import sys

import torch

from sgc_tpu_torch.utils.device import resolve_device
from sgc_tpu_torch.utils.profiling import sync


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default=None,
                   help="torch device for the smoke (default: the CUDA "
                        "card)")
    a = p.parse_args(argv)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}")
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        print(f"  device {i}: {props.name} (sm_{props.major}{props.minor}, "
              f"{props.total_memory / 2**30:.1f} GiB)")
    try:
        dev = resolve_device(a.device)
    except RuntimeError as e:
        print(f"devices: {e}", file=sys.stderr)
        return 1
    x = torch.ones((128, 128), device=dev)
    y = x @ x
    sync(dev)
    print(f"matmul smoke test on {dev}: OK (sum={float(y.sum()):.0f})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
