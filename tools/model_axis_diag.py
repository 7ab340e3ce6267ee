"""Where two tensor-parallel ranks part from the one-rank model.

Phases 7d and 7e of ``chip_smoke.py`` hold the first prompt's logits of 2
gloo ranks to the one-rank model's: Jamba (its first 4 layers at full
width; the default), xlstm-125m or seamless-m4t-medium (whole; its
prompt of 14 tokens and 300 stub frames).  This script prints, for that
prompt, each layer's hidden state error of rank 0 against the one rank
(max and rms over all positions, the last row's max), the logits' error
over the real vocab, and for each router call the prompt tokens that the
rank routes otherwise, with the one rank's boundary gap there (its k-th
largest router logit minus its (k+1)-th); then the same with every
partial product made float32 before its all-reduce (the MLP, the MoE
mixture, the attention output (self, encoder, cross), Mamba's and the
mLSTM's ``out_proj``, the sLSTM's ``down``), to tell rounding from a
routing flip.  (The port sums the xLSTM's two output partials in
float32; the first variant sums them in bf16, each partial rounded.)  The one-rank model is freed before the ranks start (Jamba
and two ranks do not fit on one 80 GB card together).  Run on a machine
with an H100 (~40 s):

    python3 tools/model_axis_diag.py [jamba|xlstm|seamless]
"""

import gc
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch.launch import dist  # noqa: E402
from repro_torch.models import attention as attn_lib  # noqa: E402
from repro_torch.models import layers as layers_lib  # noqa: E402
from repro_torch.models import model as model_lib  # noqa: E402
from repro_torch.models import moe as moe_lib  # noqa: E402
from repro_torch.models import ssm as ssm_lib  # noqa: E402
from repro_torch.models import xlstm as xlstm_lib  # noqa: E402

# stack -> (arch, layers or None for all of them)
STACKS = {"jamba": (cs.JAMBA, cs.JAMBA_LAYERS), "xlstm": (cs.XLSTM, None),
          "seamless": (cs.ENCDEC, None)}


def stack_config(name):
    arch, layers = STACKS[name]
    cfg = cs.get_config(arch)
    return cfg if layers is None else cfg.replace(num_layers=layers)


def prompt_logits(model, tok, reqs):
    """The first prompt's last logits (seamless: ``xe_batch``'s tokens and
    frames), on the host."""

    if not model.cfg.encoder_decoder:
        return cs.first_logits(model, tok, reqs)
    batch = {k: torch.as_tensor(v, device=model.device)
             for k, v in cs.xe_batch(model.cfg, tok).items()}
    return model.prefill(batch)[0][0, -1].float().cpu().numpy()


def first(model, tok, reqs):
    """The first prompt's logits, each router call's (sets, gaps) and each
    layer's output hidden state [S, D], all numpy."""

    hidden = []
    block_seq = model._block_seq

    def record(i, x, *a, **kw):
        out = block_seq(i, x, *a, **kw)
        hidden.append(out[0].float().cpu().numpy())
        return out

    model._block_seq = record
    try:
        with cs.RouteLog() as routes:
            logits = prompt_logits(model, tok, reqs)
    finally:
        del model._block_seq
    return logits, [(s.cpu().numpy(), g.cpu().numpy()) for s, g in routes.calls], hidden


# the xLSTM's output sum as the port takes it (float32 partials), and as
# the "bf16 partials" variant takes it (each partial and the sum rounded)
XLSTM_SUM = xlstm_lib._sum_over


def bf16_sum(y, w, tp):
    return dist.all_reduce_sum(xlstm_lib.dense(y, w), tp)


def float32_partials(model):
    """Make the four partial products float32 before their all-reduce (the
    sum rounded to the model's dtype once, after it)."""

    d, dtype = model.cfg.d_model, model.dtype
    dense, reduce = ssm_lib.dense, ssm_lib.all_reduce_sum

    def mamba_dense(x, w):
        return x.float() @ w.float() if w.shape[1] == d else dense(x, w)

    def mamba_reduce(x, g):
        out = reduce(x, g)
        return out.to(dtype) if x.shape[-1] == d else out

    def mlp(x, m, activation="silu"):
        act = layers_lib.ACTIVATIONS[activation]
        h = layers_lib.dense(x, m.up.w)
        h = act(layers_lib.dense(x, m.gate.w)) * h if hasattr(m, "gate") else act(h)
        return dist.all_reduce_sum(h.float() @ m.down.w.float(), m.tp).to(x.dtype)

    def mixture(x, combine, p):
        b, s, dd = x.shape
        t, e = b * s, p.up.shape[0]
        cmb = combine.reshape(t, e).T.to(x.dtype)[..., None]
        h = moe_lib._hidden(x.reshape(1, t, dd), p, slice(None)) * cmb
        part = torch.bmm(h.float(), p.down.float()).sum(0)
        return dist.all_reduce_sum(part, p.tp).reshape(b, s, dd).to(x.dtype)

    def out(o, p):
        b, s = o.shape[:2]
        return dist.all_reduce_sum(o.reshape(b, s, -1).float() @ p.wo.float(), p.tp).to(o.dtype)

    ssm_lib.dense, ssm_lib.all_reduce_sum = mamba_dense, mamba_reduce
    xlstm_lib._sum_over = XLSTM_SUM  # the port's own: float32 partials
    model_lib.mlp = mlp
    moe_lib.moe_apply_experts = mixture
    attn_lib._out = out


def rank_main(rank, backend, init, device, name, reqs, queue):
    try:
        os.environ["GLOO_SOCKET_IFNAME" if backend == "gloo" else "NCCL_SOCKET_IFNAME"] = "lo"
        torch.backends.cuda.matmul.allow_tf32 = False
        group = dist.init_model_group(rank, cs.MODEL_AXIS, backend=backend, init_method=init,
                                      device=device)
        dev = group.device
        cfg = stack_config(name)
        model = cs.Model(cfg, device=dev, generator=torch.Generator(dev).manual_seed(0),
                         group=group)
        tok = cs.EpisodeTokenizer(cfg.vocab_size)
        xlstm_lib._sum_over = bf16_sum
        base = first(model, tok, reqs)
        float32_partials(model)
        queue.put((rank, {"bf16 partials": base, "float32 partials": first(model, tok, reqs)}))
        dist.destroy_model_group(group)
    except Exception:  # the rank's failure goes to the parent
        import traceback

        queue.put((rank, traceback.format_exc()))


def main(name):
    t0 = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    cs.log(f"card: {cs.card_line()}; {name}")
    cs._lib.build_all(force=True)
    cfg = stack_config(name)
    model = cs.Model(cfg, device="cuda", generator=torch.Generator("cuda").manual_seed(0))
    tok = cs.EpisodeTokenizer(cfg.vocab_size)
    reqs = (cs.requests(np.random.default_rng(9), cs.JAMBA_AXIS_ROBOTS) if name == "jamba"
            else cs.requests(np.random.default_rng(11), cs.XE_ROBOTS))
    one = first(model, tok, reqs)
    del model
    gc.collect()
    torch.cuda.empty_cache()
    backend, devices = cs.axis_plan()
    ranks = cs.join_model_axis(*cs.start_model_axis(backend, devices, name, reqs,
                                                    target=rank_main, timeout_s=240,
                                                    what="diag"))
    v = cfg.vocab_size
    for variant, (logits, routes, hidden) in ranks[0].items():
        cs.log(f"== {variant}: logits max abs error {np.abs(logits - one[0])[:v].max():.4g} "
               f"(max |logit| {np.abs(one[0][:v]).max():.4g}, over the {v} real ids); rank 1 "
               f"equal {np.array_equal(logits, ranks[1][variant][0])}")
        for i, (h, h1) in enumerate(zip(hidden, one[2])):
            err = np.abs(h - h1)
            cs.log(f"  layer {i}: max abs error {err.max():.4g} (last row {err[-1].max():.4g}), "
                   f"rms {np.sqrt((err ** 2).mean()):.4g}; max |x| {np.abs(h1).max():.4g}, rms "
                   f"{np.sqrt((h1 ** 2).mean()):.4g}")
        for c, ((sa, ga), (sb, _)) in enumerate(zip(one[1], routes)):
            rows = np.flatnonzero((sa != sb).any(-1))
            cs.log(f"  router call {c}: tokens routed otherwise {rows.tolist()}, one-rank gaps "
                   f"there {ga[rows].round(5).tolist()} (smallest gap {ga.min():.4g})")
    cs.log(f"{time.perf_counter() - t0:.1f} s")


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else "jamba")
