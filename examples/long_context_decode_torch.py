"""BANG-KV demo on the PyTorch port: the paper's pipeline as long-context
decode attention.

Prefills a context with a small LM, fits PQ codebooks per layer on the
prefill keys (stage 0), then decodes with BANG-KV retrieval attention (ADC
scan + exact re-rank over top-L + window) beside exact attention, and
prints the logit correlation and argmax agreement of each step. The
counterpart of `examples/long_context_decode.py`; by default the same
reduced glm4-9b, so the two print comparable lines (their random weights
and tokens differ: JAX keys against a `torch.Generator`).

`--arch zamba2-2.7b` retrieves from the caches of the hybrid's shared
attention block (one a group of SSM layers), `--arch whisper-medium` from
the decoder's self-attention caches (its encoder runs over random frame
embeddings, the stub front end); `--arch mamba2-2.7b` is attention-free, so
there is no KV cache to retrieve from: the script says so and exits 2.

    PYTHONPATH=src python examples/long_context_decode_torch.py                # on the card
    PYTHONPATH=src python examples/long_context_decode_torch.py --device cpu --context 192
    PYTHONPATH=src python examples/long_context_decode_torch.py --device cpu --arch zamba2-2.7b
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import repro_torch.configs as configs  # noqa: E402
from repro_torch.kernels.common import resolve_device  # noqa: E402
from repro_torch.models import LM  # noqa: E402
from repro_torch.models.attention import KVCache  # noqa: E402
from repro_torch.models.retrieval_attention import fit_bangkv_caches  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    attention_caches, clone_caches, with_attention_caches)


def logit_corr(a: torch.Tensor, b: torch.Tensor) -> float:
    """Pearson correlation of two logit vectors, in float64."""
    return float(torch.corrcoef(torch.stack([a.double(), b.double()]))[0, 1])


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="glm4-9b")
    ap.add_argument("--context", type=int, default=192)
    ap.add_argument("--decode-steps", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = configs.get(args.arch)
    if cfg.family == "ssm":
        print(f"[bangkv] {cfg.name} is attention-free (Mamba2 layers only): its decode state is a "
              "fixed-size SSM state, with no KV cache for BANG-KV to retrieve from", file=sys.stderr)
        raise SystemExit(2)
    cfg = cfg.reduced(
        d_model=128, n_heads=8, n_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, bangkv_m=8, bangkv_topl=32, bangkv_window=32,
    )
    dev = resolve_device(args.device)
    g = torch.Generator(dev).manual_seed(args.seed)
    lm = LM(cfg, device=dev, generator=g)
    B, S = 1, args.context
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g, device=dev)
    batch = {"tokens": tokens}
    if cfg.arch_kind == "encdec":
        batch["frontend"] = torch.randn((B, cfg.frontend_len, cfg.d_model), generator=g, device=dev)
        print(f"[bangkv] encoder over {cfg.frontend_len} stub frame embeddings ...")

    print(f"[bangkv] prefill {S} tokens ...")
    s_max = S + args.decode_steps
    _, exact_caches = lm.prefill(batch, s_max=s_max)

    # BANG-KV caches: fit codebooks per attention cache on the prefill keys
    # (stage 0), encode the prefill keys, then decode through the compressed
    # path. The decode writes into its caches in place, so BANG-KV gets its
    # own copy of the state.
    state = clone_caches(exact_caches)
    kv = attention_caches(cfg, state)
    print(f"[bangkv] fitting PQ codebooks on the prefill keys of {kv.k.shape[0]} attention caches ...")
    own = KVCache(kv.k, kv.v, kv.index)
    codebooks, bang_kv = fit_bangkv_caches(own, int(kv.index[0]), cfg.bangkv_m, iters=12)
    bang_caches = with_attention_caches(cfg, state, bang_kv)
    lm.set_codebooks(codebooks)

    tok = tokens[:, -1:]
    tok_b = tok
    agree, corrs = 0, []
    for s in range(args.decode_steps):
        logits_e, exact_caches = lm.decode_step(exact_caches, tok)
        logits_b, bang_caches = lm.decode_step(bang_caches, tok_b, bangkv=True)
        nxt_e = int(torch.argmax(logits_e[0, 0]))
        nxt_b = int(torch.argmax(logits_b[0, 0]))
        corr = logit_corr(logits_e[0, 0], logits_b[0, 0])
        corrs.append(corr)
        agree += nxt_e == nxt_b
        print(f"[bangkv] step {s}: exact->{nxt_e} bangkv->{nxt_b} logit corr={corr:.4f}")
        tok = torch.full((B, 1), nxt_e, dtype=torch.int32, device=dev)
        tok_b = torch.full((B, 1), nxt_b, dtype=torch.int32, device=dev)
    print(f"[bangkv] argmax agreement: {agree}/{args.decode_steps}")
    print(
        "[bangkv] compressed-path bytes/key "
        f"= {cfg.bangkv_m}B vs exact {2 * cfg.head_dim}B "
        f"({2 * cfg.head_dim / cfg.bangkv_m:.0f}x smaller in-loop reads)"
    )
    return {"corr": corrs, "agree": agree, "steps": args.decode_steps, "device": str(dev),
            "arch": cfg.name}


if __name__ == "__main__":
    main()
