"""Command-line interface: the app/lifecycle layer.

Counterpart of the reference's `app::run` + compile-time config
(`/root/reference/src/app.cpp:30-45`, `/root/reference/src/macro.h:7-27`).
Where the reference hardcodes the model path, prompt token ids, context
length, and device selection as `#define`s and recompiles to change them,
this is a real flag-driven tool:

    python -m gemma_tpu generate model.gguf --prompt "..." [--stream]
    python -m gemma_tpu inspect  model.gguf
    python -m gemma_tpu bench    model.gguf
    python -m gemma_tpu perplexity model.gguf --text-file corpus.txt

`generate` reproduces the reference's observable behavior (prefill + greedy
decode with streamed token printing and prefill/decode tokens-per-second
reporting, gemma_model.cpp:548-575) plus everything the reference lacks:
text encoding (the reference hardcodes prompt ids, gemma_model.cpp:549),
sampling controls, batching, paged/quantized KV, and profiling output.
"""
from __future__ import annotations

import argparse
import json
import sys
import time


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("model", help="path to a GGUF checkpoint")
    p.add_argument(
        "--mode", choices=("quantized", "dequant"), default="quantized",
        help="serve block-quantized weights via fused Pallas kernels "
        "(quantized) or dequantize everything to bf16 at load (dequant)",
    )


def _add_engine_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--max-seq-len", type=int, default=512,
                   help="KV-cache capacity (reference ctx: macro.h:8-9)")
    p.add_argument("--kv-quant", action="store_true",
                   help="int8-quantize the KV-cache")
    p.add_argument("--paged", action="store_true",
                   help="use the paged KV-cache (block tables)")
    p.add_argument("--page-size", type=int, default=64,
                   help="paged KV page length: a power of two >= 16 (one "
                   "page is one block of the decode kernel)")
    p.add_argument("--profile", action="store_true",
                   help="print the op-span/roofline report at exit "
                   "(reference: print_profiling_result, app.cpp:42)")
    p.add_argument("--verify", action="store_true",
                   help="before running, diff the Pallas kernels against "
                   "the XLA fallback on-device for one prefill + 4 decode "
                   "steps (the reference's in-situ kernel check, "
                   "kernals.cl:203-213); abort on mismatch")
    p.add_argument("--profile-sync", type=int, default=1, metavar="N",
                   help="with --profile: block on the device every Nth "
                   "decode dispatch so span times are true device time, "
                   "not async queueing (0 disables; slows the run by the "
                   "dispatch round-trip)")


def _load(args, need_tokenizer: bool = True):
    from .gguf.reader import GGUFReader
    from .models.params import load_params
    from .tokenizer.sentencepiece import Tokenizer

    t0 = time.time()
    reader = GGUFReader(args.model)
    cfg, params = load_params(reader, mode=args.mode)
    tok = Tokenizer.from_gguf(reader) if need_tokenizer else None
    print(f"loaded {args.model} in {time.time() - t0:.1f}s "
          f"({cfg.n_layers} layers, d_model={cfg.d_model}, "
          f"vocab={cfg.vocab_size})", file=sys.stderr)
    return reader, cfg, params, tok


def _maybe_verify(args, cfg, params, prompt: list[int] | None = None) -> bool:
    """Run the on-device Pallas-vs-XLA kernel diff when --verify is set
    (honored by generate, bench, AND serve — a correctness gate that only
    fires on one subcommand is false assurance on the others). Returns
    False on mismatch."""
    if not getattr(args, "verify", False):
        return True
    from .utils.verify import format_report, verify_device_kernels

    if prompt is None:
        prompt = [2 + (i % max(2, cfg.vocab_size - 2)) for i in range(64)]
    res = verify_device_kernels(
        cfg, params, prompt[: min(len(prompt), 64)],
        max_seq_len=args.max_seq_len, kv_quantized=args.kv_quant,
        paged=args.paged, page_size=args.page_size,
    )
    print(format_report(res), file=sys.stderr)
    return bool(res["ok"])


def cmd_generate(args) -> int:
    from .runtime import Engine, EngineConfig
    from .runtime.sampler import SamplingParams
    from .utils import profiling

    if args.profile:
        profiling.enable(sync_every=max(0, args.profile_sync))
        profiling.autoset_peaks()
    reader, cfg, params, tok = _load(args)

    if args.tokens:
        prompt = [int(t) for t in args.tokens.split(",")]
    else:
        text = args.prompt
        if args.chat:
            # Gemma instruction-tuned turn format — the reference HARDCODES
            # a chat-templated id sequence (gemma_model.cpp:549); this
            # produces it from text (control tokens match literally in the
            # tokenizer and encode to single ids)
            text = (f"<start_of_turn>user\n{text}<end_of_turn>\n"
                    "<start_of_turn>model\n")
        prompt = tok.encode(text)
    if len(prompt) >= args.max_seq_len:
        print(f"prompt ({len(prompt)} tokens) must be shorter than "
              f"--max-seq-len {args.max_seq_len}", file=sys.stderr)
        return 2

    if not _maybe_verify(args, cfg, params, prompt):
        return 3

    eng = Engine(
        cfg, params,
        EngineConfig(
            max_seq_len=args.max_seq_len, max_batch=1,
            kv_quantized=args.kv_quant,
            paged=args.paged, page_size=args.page_size,
        ),
    )
    sampling = SamplingParams(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p
    )
    eos = tok.special.eos if args.eos else None
    budget = min(args.max_new_tokens, args.max_seq_len - len(prompt))

    pieces: list[str] = []

    def on_token(step: int, toks: list[int]) -> None:
        text = tok.decode([toks[0]])
        pieces.append(text)
        if args.stream:
            print(text, end="", flush=True)

    # separate prefill/decode wall-clock, like the reference's report
    # (gemma_model.cpp:566-572). Prefill is timed to first-token logits on
    # host (true TTFT); decode is the remaining generation wall time.
    import numpy as np

    t0 = time.time()
    first_logits, cache = eng.prefill([prompt])
    np.asarray(first_logits[:1, :1])  # force device sync for honest TTFT
    t_prefill = time.time() - t0

    t1 = time.time()
    if args.speculative and sampling.is_greedy:
        from .runtime.speculative import SpecDecoder

        spec = SpecDecoder(eng, k=args.spec_k)
        out = spec.generate(prompt, budget)
        if eos is not None and eos in out:
            out = out[: out.index(eos) + 1]
        for t in out if args.stream else ():
            on_token(0, [t])
    else:
        if args.speculative:
            print("--speculative requires greedy sampling; ignoring",
                  file=sys.stderr)
        out = eng.generate_from(
            first_logits, cache, budget, sampling=sampling, eos_id=eos,
            seed=args.seed, on_token=on_token if args.stream else None,
        )[0]
    t_decode = time.time() - t1
    if args.stream:
        print()
    else:
        print(tok.decode(out))
    n = len(out)
    print(
        f"[prefill {len(prompt)} tokens in {t_prefill*1e3:.1f} ms "
        f"({len(prompt)/max(t_prefill,1e-9):.1f} tok/s); "
        f"decode {n} tokens in {t_decode:.2f}s "
        f"({n/max(t_decode,1e-9):.2f} tok/s)]",
        file=sys.stderr,
    )
    if args.profile:
        print(profiling.report(), file=sys.stderr)
    return 0


def cmd_inspect(args) -> int:
    """Dump GGUF header KV pairs and tensor info (the introspection the
    reference buries in MASK()-gated logging, gemma_model.cpp:604-644)."""
    from .gguf.reader import GGUFReader

    reader = GGUFReader(args.model)
    if args.json:
        meta = {
            "architecture": reader.architecture,
            "kv": {k: _jsonable(v) for k, v in reader.metadata.items()},
            "tensors": {
                t.name: {"shape": list(t.shape), "type": t.ggml_type.name}
                for t in reader
            },
        }
        print(json.dumps(meta, indent=2))
        return 0
    print(f"architecture: {reader.architecture}")
    print(f"{len(reader.metadata)} KV pairs, {len(reader.tensors)} tensors")
    for k, v in reader.metadata.items():
        s = str(v)
        if len(s) > 80:
            s = f"{s[:77]}... ({len(v)} items)" if isinstance(v, list) else s[:77] + "..."
        print(f"  {k} = {s}")
    for t in reader:
        print(f"  {t.name}  {list(t.shape)}  {t.ggml_type.name}")
    return 0


def _jsonable(v):
    import numpy as np

    if isinstance(v, bytes):
        return v.decode("utf-8", "replace")
    if isinstance(v, np.ndarray):
        v = v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, list):
        if len(v) > 64:
            v = v[:64] + [f"... truncated"]
        return [_jsonable(x) for x in v]
    return v


def cmd_bench(args) -> int:
    """Decode-throughput benchmark on a real checkpoint (bench.py at the
    repo root is the synthetic-weights variant the driver runs)."""
    import numpy as np

    from .runtime import Engine, EngineConfig

    reader, cfg, params, tok = _load(args)
    if not _maybe_verify(args, cfg, params):
        return 3
    eng = Engine(
        cfg, params,
        EngineConfig(
            max_seq_len=args.max_seq_len, max_batch=args.batch,
            kv_quantized=args.kv_quant,
            paged=args.paged, page_size=args.page_size,
        ),
    )
    n = args.max_new_tokens
    if args.prompt:
        prompt = tok.encode(args.prompt)
    else:
        # default prompt must leave room for the 2n-token measurement run
        plen = max(1, min(64, args.max_seq_len - 2 * n - 1))
        prompt = list(range(2, 2 + plen))
    if len(prompt) + 2 * n > args.max_seq_len:
        raise SystemExit(
            f"prompt ({len(prompt)}) + 2*max_new_tokens ({2 * n}) exceeds "
            f"--max-seq-len {args.max_seq_len}"
        )
    prompts = [prompt] * args.batch
    eng.generate_fused(prompts, max_new_tokens=8)  # compile
    t0 = time.perf_counter()
    eng.generate_fused(prompts, max_new_tokens=n)
    t1 = time.perf_counter()
    eng.generate_fused(prompts, max_new_tokens=2 * n)
    t2 = time.perf_counter()
    dt = max((t2 - t1) - (t1 - t0), 1e-9)
    print(json.dumps({
        "metric": "decode_tokens_per_sec",
        "value": round(n * args.batch / dt, 2),
        "unit": "tokens/s",
        "batch": args.batch,
    }))
    return 0


def cmd_serve(args) -> int:
    """Offline-batch serving: read prompts (one per line), drive the
    continuous-batching scheduler, print completions + stats. The serving
    loop the reference cannot express (one hardcoded prompt per process,
    gemma_model.cpp:548-575)."""
    from .runtime import Engine, EngineConfig, Request, SamplingParams, serve

    reader, cfg, params, tok = _load(args)
    if not _maybe_verify(args, cfg, params):
        return 3
    eng = Engine(
        cfg, params,
        EngineConfig(
            max_seq_len=args.max_seq_len, max_batch=args.batch,
            kv_quantized=args.kv_quant,
            paged=args.paged, page_size=args.page_size,
            prefill_chunk=args.prefill_chunk,
        ),
    )
    lines = (
        open(args.prompts_file, encoding="utf-8").read().splitlines()
        if args.prompts_file
        else [ln for ln in sys.stdin.read().splitlines()]
    )
    lines = [ln for ln in lines if ln.strip()]
    eos = tok.special.eos if args.eos else None
    reqs = [
        Request(f"r{i}", tok.encode(ln), max_new_tokens=args.max_new_tokens,
                eos_id=eos)
        for i, ln in enumerate(lines)
    ]
    sampling = SamplingParams(
        temperature=args.temperature, top_k=args.top_k, top_p=args.top_p
    )
    speculative = args.speculative
    if speculative and (not sampling.is_greedy or args.paged):
        print("--speculative requires greedy sampling and the dense cache; "
              "ignoring", file=sys.stderr)
        speculative = False
    t0 = time.monotonic()
    sched = serve(eng, reqs, sampling=sampling, block=args.block,
                  seed=args.seed, speculative=speculative,
                  spec_k=args.spec_k, spec_block=args.spec_block)
    wall = time.monotonic() - t0
    for r in sorted(sched.finished, key=lambda r: int(r.id[1:])):
        print(json.dumps({"id": r.id, "text": tok.decode(r.tokens),
                          "tokens": len(r.tokens),
                          "ttft_s": round(r.ttft, 4) if r.ttft else None}))
    stats = sched.stats()
    stats["wall_s"] = round(wall, 2)
    print(json.dumps(stats), file=sys.stderr)
    return 0


def cmd_quantize(args) -> int:
    """Re-quantize a GGUF checkpoint natively (the role llama.cpp's
    `quantize` tool plays in the reference's ecosystem — the reference
    itself can only consume pre-quantized files, app.cpp:36).

    2-D matrices quantize to --type (or the mixed q4_k_m recipe: q4_k with
    q6_k attn_v + embedding/head); 1-D norms and any matrix whose row
    length doesn't divide the block size stay f32."""
    import numpy as np

    from .gguf.constants import GGMLType
    from .gguf.reader import GGUFReader
    from .gguf.writer import GGUFWriter
    from .quant import numpy_ref

    t0 = time.time()
    reader = GGUFReader(args.model)
    w = GGUFWriter(args.out)
    # llama.cpp LLAMA_FTYPE_* values: the output must advertise ITS quant
    # type, not the source's (downstream tooling reads general.file_type)
    ftype = {"f16": 1, "q4_0": 2, "q8_0": 7, "q4_k": 14, "q4_k_m": 15,
             "q5_k": 16, "q5_k_m": 17, "q6_k": 18}[args.type]
    for k, v in reader.metadata.items():
        w.add_kv(k, np.uint32(ftype) if k == "general.file_type" else v)
    if "general.file_type" not in reader.metadata:
        w.add_kv("general.file_type", np.uint32(ftype))

    name_to_type = {
        "q4_0": GGMLType.Q4_0, "q8_0": GGMLType.Q8_0,
        "q4_k": GGMLType.Q4_K, "q5_k": GGMLType.Q5_K,
        "q6_k": GGMLType.Q6_K, "f16": GGMLType.F16,
    }
    mixed = args.type in ("q4_k_m", "q5_k_m")
    base = (
        {"q4_k_m": GGMLType.Q4_K, "q5_k_m": GGMLType.Q5_K}[args.type]
        if mixed else name_to_type[args.type]
    )
    block = {GGMLType.Q4_0: 32, GGMLType.Q8_0: 32, GGMLType.Q4_K: 256,
             GGMLType.Q5_K: 256, GGMLType.Q6_K: 256, GGMLType.F16: 1}

    n_q = 0
    for ti in reader:
        from . import native

        raw = reader.tensor_raw(ti.name)
        x = native.dequantize(raw, ti.ggml_type, ti.shape)
        if x is None:
            x = numpy_ref.dequantize(raw, ti.ggml_type, ti.shape)
        x = np.asarray(x, np.float32)
        t = base
        if mixed and (ti.name in ("token_embd.weight", "output.weight")
                      or ti.name.endswith("attn_v.weight")):
            t = GGMLType.Q6_K
        if x.ndim != 2 or x.shape[-1] % block[t] != 0:
            w.add_tensor(ti.name, x, tuple(x.shape), GGMLType.F32)
            continue
        w.add_tensor(ti.name, numpy_ref.quantize(x, t), tuple(x.shape), t)
        n_q += 1
    w.write()
    print(f"quantized {n_q} matrices -> {args.out} "
          f"({args.type}) in {time.time()-t0:.1f}s", file=sys.stderr)
    return 0


def cmd_perplexity(args) -> int:
    from .utils.perplexity import evaluate

    reader, cfg, params, tok = _load(args)
    if args.text_file:
        text = open(args.text_file, encoding="utf-8").read()
    else:
        text = sys.stdin.read()
    ids = tok.encode(text)
    res = evaluate(params, cfg, ids, ctx=args.window)
    print(json.dumps({"perplexity": res.ppl, "tokens": res.n_tokens}))
    return 0


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="gemma_tpu",
        description="Quantized Gemma inference engine",
    )
    sub = ap.add_subparsers(dest="command", required=True)

    g = sub.add_parser("generate", help="prefill + decode one prompt")
    _add_common(g)
    _add_engine_flags(g)
    g.add_argument("--prompt", default="Hello", help="prompt text")
    g.add_argument("--tokens", default=None,
                   help="comma-separated prompt token ids (bypasses encode)")
    g.add_argument("--max-new-tokens", type=int, default=128)
    g.add_argument("--temperature", type=float, default=0.0,
                   help="0 = greedy (the reference's only sampler, "
                   "gemma_model.cpp:532-546)")
    g.add_argument("--top-k", type=int, default=0)
    g.add_argument("--top-p", type=float, default=1.0)
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--speculative", action="store_true",
                   help="prompt-lookup speculative decoding (greedy only): "
                   "drafts k tokens from the token history and verifies "
                   "them in one forward — exact greedy stream, >1 token "
                   "per weight pass on repetitive continuations")
    g.add_argument("--spec-k", type=int, default=7,
                   help="draft tokens per speculative verify step")
    g.add_argument("--chat", action="store_true",
                   help="wrap the prompt in the Gemma instruction-tuned "
                   "turn template (the reference's hardcoded prompt is "
                   "chat-templated ids, gemma_model.cpp:549)")
    g.add_argument("--stream", action="store_true",
                   help="print tokens as they decode")
    g.add_argument("--no-eos", dest="eos", action="store_false",
                   help="ignore EOS and generate max-new-tokens")
    g.set_defaults(fn=cmd_generate)

    i = sub.add_parser("inspect", help="dump GGUF metadata and tensor info")
    i.add_argument("model")
    i.add_argument("--json", action="store_true")
    i.set_defaults(fn=cmd_inspect)

    b = sub.add_parser("bench", help="decode throughput on a checkpoint")
    _add_common(b)
    _add_engine_flags(b)
    b.add_argument("--prompt", default=None)
    b.add_argument("--max-new-tokens", type=int, default=128)
    b.add_argument("--batch", type=int, default=1)
    b.set_defaults(fn=cmd_bench)

    p = sub.add_parser("perplexity", help="perplexity over a text corpus")
    _add_common(p)
    p.add_argument("--text-file", default=None,
                   help="UTF-8 text file (default: stdin)")
    p.add_argument("--window", type=int, default=512)
    p.set_defaults(fn=cmd_perplexity)

    s = sub.add_parser("serve", help="batch-serve prompts (one per line) "
                       "through the continuous-batching scheduler")
    _add_common(s)
    _add_engine_flags(s)
    s.add_argument("--prompts-file", default=None,
                   help="file of prompts, one per line (default: stdin)")
    s.add_argument("--batch", type=int, default=8,
                   help="decode slots (concurrent sequences)")
    s.add_argument("--max-new-tokens", type=int, default=128)
    s.add_argument("--block", type=int, default=8,
                   help="decode tokens per dispatched program")
    s.add_argument("--prefill-chunk", type=int, default=0,
                   help="chunk admission prefills to this many tokens")
    s.add_argument("--temperature", type=float, default=0.0)
    s.add_argument("--top-k", type=int, default=0)
    s.add_argument("--top-p", type=float, default=1.0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--no-eos", dest="eos", action="store_false")
    s.add_argument("--speculative", action="store_true",
                   help="batched prompt-lookup speculation (greedy + dense "
                   "cache): every slot drafts+verifies spec-k tokens per "
                   "tick, adaptive-k backoff on draft-hostile content")
    s.add_argument("--spec-k", type=int, default=7)
    s.add_argument("--spec-block", type=int, default=4,
                   help="chained verify ticks per dispatch")
    s.set_defaults(fn=cmd_serve)

    q = sub.add_parser("quantize", help="re-quantize a checkpoint natively")
    q.add_argument("model", help="source GGUF (any format)")
    q.add_argument("out", help="output GGUF path")
    q.add_argument("--type", default="q4_0",
                   choices=("q4_0", "q8_0", "q4_k", "q5_k", "q6_k",
                            "q4_k_m", "q5_k_m", "f16"))
    q.set_defaults(fn=cmd_quantize)
    return ap


def main(argv: list[str] | None = None) -> int:
    from .compile_cache import setup_compile_cache

    args = build_parser().parse_args(argv)
    setup_compile_cache()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
