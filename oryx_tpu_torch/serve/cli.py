"""Inference CLI: `python -m oryx_tpu_torch.serve.cli --model-path DIR ...`.

The JAX package's serve/cli.py for the port: a one-shot `--question` over
the given images or video through `Pipeline.chat`, or an `--interactive`
REPL over `ChatSession(..., shared=True)` that streams each answer
(`:reset` clears the history, `:q` exits). DIR is a directory written by
`builder.save_pretrained` (`oryx_config.json` + `model.safetensors`); the
tokenizer comes from DIR or `--tokenizer-path`. A video is a file PIL can
read frame by frame or a directory of frame images. It runs on the card
(`--device cuda`, the default) unless `--device cpu` is asked for.

    python -m oryx_tpu_torch.serve.cli --model-path DIR \\
        --image a.png --question "what is this?" [--quantize int8]

`--shard tp=N` serves the model tensor-parallel over N ranks this
process starts (parallel/), `--shard fsdp=N` with each rank holding its
shard of every layer, gathered as the layer runs.
"""

from __future__ import annotations

import argparse
import sys

from oryx_tpu_torch.data import media


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Oryx inference (PyTorch port)")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument(
        "--question", default=None,
        help="one-shot question (omit with --interactive)",
    )
    ap.add_argument(
        "--interactive", action="store_true",
        help="multi-turn REPL over the given media; ':reset' clears "
        "history, ':q' exits",
    )
    ap.add_argument("--image", action="append", default=[],
                    help="image path (repeatable)")
    ap.add_argument("--video", default=None,
                    help="video file or directory of frames")
    ap.add_argument("--num-frames", type=int, default=64)
    ap.add_argument("--max-new-tokens", type=int, default=None)
    ap.add_argument("--template", default="qwen")
    ap.add_argument(
        "--shard", default=None, metavar="MODE=N",
        help="sharded serving over N ranks, e.g. tp=2 or fsdp=2",
    )
    ap.add_argument(
        "--quantize", default=None, choices=["int8"],
        help="weight-only int8 for single-card serving (halves weight "
        "memory; mutually exclusive with --shard)",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu)")
    return ap


def main(argv: list[str] | None = None) -> None:
    ap = build_argparser()
    args = ap.parse_args(argv)
    if args.question is None and not args.interactive:
        ap.error("--question is required unless --interactive")
    if args.quantize and args.shard:
        ap.error("--quantize is single-chip serving; drop --shard")

    from oryx_tpu_torch.serve import builder
    from oryx_tpu_torch.serve.pipeline import ChatSession

    pipe = builder.shard_pipeline(
        args.model_path, args.shard, tokenizer_path=args.tokenizer_path,
        template=args.template, quantize=args.quantize, device=args.device,
    )

    if args.video is not None:
        images = media.load_video_frames(args.video, args.num_frames)
        is_video = True
    else:
        images = [media.load_image(p) for p in args.image]
        is_video = False

    if args.interactive:
        # shared=True: a `:reset` re-seeds from the pipeline's prefix index
        # instead of prefilling the media and system prompt again.
        session = ChatSession(
            pipe, images=images, is_video=is_video, shared=True
        )

        def answer(q: str) -> None:
            print("assistant: ", end="", flush=True)
            for delta in session.ask_stream(
                q, max_new_tokens=args.max_new_tokens
            ):
                print(delta, end="", flush=True)
            print()

        if args.question:
            print(f"user: {args.question}")
            answer(args.question)
        while True:
            try:
                q = input("user: ").strip()
            except EOFError:
                break
            if q in (":q", ":quit", ":exit"):
                break
            if q == ":reset":
                session.reset()
                continue
            if not q:
                continue
            answer(q)
        return

    answer = pipe.chat(
        args.question, images=images or None, is_video=is_video,
        max_new_tokens=args.max_new_tokens,
    )
    print(answer)


if __name__ == "__main__":
    main(sys.argv[1:])
