"""Run every gather-probe case on the card:

    python -m ethzasl_brisk_tpu_torch.probes

For each call of the ``pallas_call`` sites of P1, P3 and P2 (39 cases) it
builds the probe's full-size inputs on the card, launches the serving
kernel once (counted), holds the result bitwise against the plain version,
and prints kernel (event and device), plain and library (event and device)
times, the bound, the rate in elements/s and the card's name and power
limit. A mismatch or launch error raises. Needs a CUDA card.
"""
import sys

import torch

from ethzasl_brisk_tpu_torch import measure
from ethzasl_brisk_tpu_torch.probes import cases


def main() -> int:
    if not torch.cuda.is_available():
        print("probes: no CUDA device; the probes run on the card only", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    card = measure.card_line(dev)
    print(f"[card] {card}", flush=True)
    cases.run_all(dev, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
