"""Train a (reduced) assigned-architecture LM end-to-end on the synthetic
token pipeline with checkpoint/restart, through ``repro_torch`` (the
counterpart of ``train_lm.py``).

    PYTHONPATH=src python examples/train_lm_torch.py [--arch qwen2-0.5b] [--device cpu]

Delegates to ``repro_torch.launch.train`` (bf16 working weights, an f32
master, the flash kernel's forward under autograd on the card); asserts the
loss decreases. It runs on the card by default and raises without one;
``--device cpu`` runs the attention's plain version on the host.
"""
import argparse
import tempfile

from repro_torch.launch import train as train_mod


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--device", default=None,
                    help="default: the current CUDA device; 'cpu' runs on the host")
    args = ap.parse_args(argv)

    with tempfile.TemporaryDirectory() as d:
        losses = train_mod.main([
            "--arch", args.arch, "--reduced", "--steps", str(args.steps),
            "--batch", "8", "--seq", "48", "--ckpt-dir", d,
            "--lr", "2e-3",
        ] + ([] if args.device is None else ["--device", args.device]))
    drop = losses[0] - losses[-1]
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f} (drop {drop:.3f})")
    assert drop > 0.1, "loss should decrease"
    print("OK")
    return losses


if __name__ == "__main__":
    main()
