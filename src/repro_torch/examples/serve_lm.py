"""Continuous-batching serving example (see ``repro_torch.launch.serve``).

  PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu \\
      --prefill-chunk 16 --temperature 0.7 --top-k 8

Overload controls arm deadline-aware admission, bounded-queue
backpressure, load shedding and staged degraded modes:

  PYTHONPATH=src python -m repro_torch.examples.serve_lm --device cpu \\
      --requests 8 --ttft-deadline-s 5.0 --total-deadline-s 30.0 \\
      --rate-per-s 50 --max-queue 32 --queue-high 8 --queue-low 2

Architectures the port does not serve yet are refused by the launcher.
"""

import sys

from ..launch.serve import main

if __name__ == "__main__":
    main(sys.argv[1:])
