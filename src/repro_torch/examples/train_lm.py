"""End-to-end training example (see ``repro_torch.launch.train``).

A thin veneer over the training launcher: the same train step, PGAS
registration, checkpoint and straggler machinery, on a reduced config
(``--reduced`` is added unless given) with checkpoints in
``--checkpoint-dir`` (default ``build/train_lm_ckpt`` under the current
directory).  A few hundred steps of a reduced glm4-9b on 8 virtual ranks:

  PYTHONPATH=src python -m repro_torch.examples.train_lm --arch glm4-9b \\
      --steps 200 --device cpu
"""

import sys

from ..launch.train import main as _train_main


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--reduced" not in argv:
        argv.append("--reduced")
    if not any(a.startswith("--checkpoint-dir") for a in argv):
        argv += ["--checkpoint-dir", "build/train_lm_ckpt"]
    return _train_main(argv)


if __name__ == "__main__":
    main()
