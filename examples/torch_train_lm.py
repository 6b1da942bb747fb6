"""Train a small LM (the gemma2-9b *smoke* config: the same code path as
the full config) for a few hundred steps with checkpoint/restart
(``examples/train_lm.py`` on ``repro_torch``).

    PYTHONPATH=src python examples/torch_train_lm.py [--steps 200] \\
        [--device cpu]

Runs ``repro_torch.launch.train`` with ``--arch gemma2-9b`` and the
example's defaults (200 steps, batch 8, sequence length 64, checkpoints in
``repro_torch_lm_ckpt`` under ``tempfile.gettempdir()``); flags given on
the command line or to ``main`` take their place.  On the CUDA card (the
default) attention is kernel 10 and its backward; ``--device cpu`` runs
the plain versions; without a card ``cuda`` raises.  A rerun in the same
checkpoint directory resumes from its last checkpoint.  ``main`` returns
the launcher's result (``losses`` of the steps it ran, ``final_step``).
"""
import os
import sys
import tempfile

from repro_torch.launch.train import main as train_main


def defaults() -> list:
    return ["--steps", "200", "--batch", "8", "--seq-len", "64",
            "--ckpt-dir", os.path.join(tempfile.gettempdir(),
                                       "repro_torch_lm_ckpt")]


def main(argv=None) -> dict:
    argv = sys.argv[1:] if argv is None else list(argv)
    # argparse keeps a flag's last value: the caller's win over defaults()
    return train_main(["--arch", "gemma2-9b"] + defaults() + argv)


if __name__ == "__main__":
    main()
