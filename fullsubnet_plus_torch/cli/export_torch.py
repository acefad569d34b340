"""Export an .npz checkpoint as a reference-format PyTorch checkpoint.

    python -m fullsubnet_plus_torch.cli.export_torch \
        -M checkpoints/best_model.npz -O best_model.tar [--model fullsubnet_plus] [--lr LR]

Counterpart of fullsubnet_plus_tpu/cli/export_torch.py with the same flags
and files. The `.npz` (either package's: the JAX package's layout and
keys) goes through the weight bridge (io/convert.py) into the reference's
state_dict, which loads into the reference's `FullSubNet_Plus` / `Model`
and into the port's modules with strict=True. `.tar` writes the reference
trainer's artifact, with Adam's moments and step when the `.npz` holds a
whole train state (`latest_model.npz`, `best_model.npz`), so the reference
trainer resumes the run; `.pth` writes the bare state_dict. Runs on the
host; nothing here touches a card.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("-M", "--checkpoint", required=True,
                        help="an .npz checkpoint (whole train state or weights only)")
    parser.add_argument("-O", "--output", required=True,
                        help="output path (.tar for the full artifact, .pth for bare weights)")
    parser.add_argument("--model", default="fullsubnet_plus",
                        choices=["fullsubnet_plus", "fullsubnet"],
                        help="which reference module tree to target")
    parser.add_argument("--lr", type=float, default=None,
                        help="learning rate of the exported Adam param_groups (torch restores "
                             "hyperparameters from them on resume); default: the lr in the "
                             "checkpoint's meta, else 1e-3")
    args = parser.parse_args(argv)

    from fullsubnet_plus_torch.io.checkpoint import (
        ADAM_PREFIX,
        load_flat,
        nested_from_flat,
        save_torch_checkpoint,
        train_state_from_flat,
    )
    from fullsubnet_plus_torch.io.convert import state_dict_from_jax

    flat, meta = load_flat(args.checkpoint)
    meta = meta or {}
    epoch = int(meta.get("epoch", 0))
    lr = args.lr if args.lr is not None else float(meta.get("lr", 1e-3))
    if any(k.startswith(ADAM_PREFIX + "/") for k in flat):
        # a whole train state: the moments and step go into the optimizer
        state = train_state_from_flat(flat)
        params = state_dict_from_jax(nested_from_flat(
            {k.removeprefix("params/"): v for k, v in flat.items() if k.startswith("params/")}),
            args.model)
        moments = {"mu": state["mu"], "nu": state["nu"], "count": state["count"]}
    else:  # weights only, as params/<path> or bare tree paths
        tree = nested_from_flat({k.removeprefix("params/"): v for k, v in flat.items()
                                 if k.startswith("params/")} or flat)
        params, moments = state_dict_from_jax(tree, args.model), {}
    save_torch_checkpoint(args.output, params, epoch=epoch, lr=lr,
                          best_score=float(meta.get("best_score", 0.0)), **moments)
    with_opt = f"with Adam state, lr={lr}" if moments else "weights-only"
    print(f"wrote {args.output} (epoch {epoch}, model {args.model}, {with_opt})")


if __name__ == "__main__":
    main()
