"""Training driver of the port: ``python -m repro_torch.launch.train --arch
<id> [...] [--device cuda|cpu]`` (counterpart of ``repro/launch/train.py``).

End to end: config -> ``Model`` -> episode or synthetic batches ->
``Model.loss_fn`` -> autograd -> AdamW under the warmup-cosine schedule ->
npz checkpoints.  The reference's flags plus ``--device`` (default
``cuda``; the attention runs the flash forward and backward kernels there,
the Mamba scan its forward and backward kernels, and their plain versions
on the CPU).  Every arch trains on either device, Jamba included.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from repro_torch.checkpoint import save
from repro_torch.checkpoint.bridge import reference_tensors
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.data.pipeline import (
    EpisodeTokenizer,
    TokenBatchIterator,
    episode_dataset,
    synthetic_lm_batches,
)
from repro_torch.models.model import Model
from repro_torch.obs.clock import clock
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update, linear_warmup_cosine

WARMUP = 20  # steps of the learning rate's linear warm-up (the reference's)


def trainable_params(model: Model):
    """The model's parameters as ``{name: tensor}``, each set to require a
    gradient (a model is built for serving, without)."""

    model.requires_grad_(True)
    return dict(model.named_parameters())


def make_train_step(model: Model, ocfg: AdamWConfig, total_steps: int):
    """-> ``train_step(params, opt_state, batch) -> (params, opt_state,
    {"loss", "grad_norm"})``: the loss and its gradients by autograd, then
    one AdamW update, in place.  The schedule's factor comes from the step
    before the update, ``linear_warmup_cosine(opt_state.step, 20, total)``,
    so the first update has learning rate 0, as in the reference."""

    def train_step(params, opt_state, batch):
        for p in params.values():
            p.grad = None
        loss, _ = model.loss_fn(batch)
        loss.backward()
        grads = {n: p.grad for n, p in params.items()}
        lr_scale = linear_warmup_cosine(opt_state.step, WARMUP, total_steps)
        opt_state, om = adamw_update(grads, opt_state, params, ocfg, lr_scale)
        return params, opt_state, {"loss": loss.detach(), **om}

    return train_step


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--arch", default="xlstm-125m")
    p.add_argument("--smoke", action="store_true", help="use the reduced config")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--seq", type=int, default=256)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--data", choices=["episodes", "synthetic"], default="episodes")
    p.add_argument("--ckpt-dir", default="")
    p.add_argument("--ckpt-every", type=int, default=100)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--device", default="cuda", help="cuda (the kernels) or cpu")
    args = p.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=args.device)
    params = trainable_params(model)
    n_params = sum(t.numel() for t in params.values())
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M")

    if args.data == "episodes":
        tok = EpisodeTokenizer(cfg.vocab_size)
        it = iter(TokenBatchIterator(episode_dataset(tok), args.batch, args.seq,
                                     action_base=tok.action_base))
    else:
        it = synthetic_lm_batches(cfg.vocab_size, args.batch, args.seq)

    ocfg = AdamWConfig(lr=args.lr)
    opt_state = adamw_init(params, ocfg)
    step_fn = make_train_step(model, ocfg, args.steps)

    losses = []
    t0 = clock()
    for step in range(args.steps):
        batch = {k: torch.as_tensor(v, device=model.device) for k, v in next(it).items()}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(
                f"step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({(clock()-t0)/(step+1):.2f}s/step)"
            )
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            path = save(args.ckpt_dir, {"params": reference_tensors(model)}, step=step + 1)
            print("saved", path)

    result = {
        "first_loss": losses[0],
        "final_loss": float(np.mean(losses[-10:])),
        "params": params,
        "model": model,
        "losses": losses,
    }
    print(f"loss {result['first_loss']:.4f} -> {result['final_loss']:.4f}")
    return result


if __name__ == "__main__":
    main()
