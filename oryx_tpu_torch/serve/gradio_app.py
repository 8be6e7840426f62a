"""Gradio web demo (optional dependency), the JAX package's
serve/gradio_app.py over the port's `Pipeline`.

Gradio is not a dependency of the port: `build_app` raises an actionable
RuntimeError without it, and the CLI (serve/cli.py) stays the first-class
path.

    python -m oryx_tpu_torch.serve.gradio_app --model-path DIR [--device cpu]
"""

from __future__ import annotations

import argparse


def build_app(pipe, *, num_frames: int = 64):
    """Build the Gradio Blocks app around a port `Pipeline`."""
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError(
            "gradio is not installed; use the CLI (oryx_tpu_torch.serve.cli) "
            "or `pip install gradio` in your serving environment"
        ) from e

    import numpy as np

    def answer(image, video, question, history, session):
        """Multi-turn chat. Media are captured from the widgets at the
        conversation's first turn and pinned in `session` for the rest of
        it: the prompt attaches them to turn one, so a widget changed
        mid-conversation would bind new media to a past turn. Start a new
        conversation to switch media."""
        history = history or []
        if not question:
            return history, "", session
        if session is None:  # first turn: capture media
            if video is not None:
                from oryx_tpu_torch.data import media

                session = {
                    "images": media.load_video_frames(video, num_frames),
                    "is_video": True,
                }
            elif image is not None:
                session = {"images": [np.asarray(image)], "is_video": False}
            else:
                session = {"images": None, "is_video": False}
        reply = pipe.chat(
            question, images=session["images"],
            is_video=session["is_video"],
            history=[tuple(t) for t in history],
        )
        return history + [(question, reply)], "", session

    with gr.Blocks(title="Oryx") as app:
        gr.Markdown("# Oryx — image / video QA")
        gr.Markdown(
            "Media are read at the first question of a conversation; "
            "press *New conversation* to ask about different media."
        )
        with gr.Row():
            image = gr.Image(label="Image", type="numpy")
            video = gr.Video(label="Video (or frames dir)")
        chat = gr.Chatbot(label="Conversation")
        session = gr.State(None)
        question = gr.Textbox(label="Question")
        with gr.Row():
            gr.Button("Ask").click(
                answer, [image, video, question, chat, session],
                [chat, question, session],
            )
            gr.Button("New conversation").click(
                lambda: ([], None), [], [chat, session]
            )
    return app


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description="Oryx Gradio demo (PyTorch port)")
    ap.add_argument("--model-path", required=True)
    ap.add_argument("--tokenizer-path", default=None)
    ap.add_argument("--num-frames", type=int, default=64)
    ap.add_argument("--port", type=int, default=7860)
    ap.add_argument(
        "--shard", default=None, metavar="MODE=N",
        help="sharded serving over N ranks (tp=N or fsdp=N)",
    )
    ap.add_argument(
        "--quantize", default=None, choices=["int8"],
        help="weight-only int8 for single-card serving (mutually exclusive "
        "with --shard)",
    )
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, or cpu)")
    args = ap.parse_args(argv)
    if args.quantize and args.shard:
        ap.error("--quantize is single-chip serving; drop --shard")

    from oryx_tpu_torch.serve import builder

    pipe = builder.shard_pipeline(
        args.model_path, args.shard, tokenizer_path=args.tokenizer_path,
        quantize=args.quantize, device=args.device,
    )
    app = build_app(pipe, num_frames=args.num_frames)
    app.launch(server_port=args.port)


if __name__ == "__main__":
    main()
