"""``apertis-torch`` command-line interface (``apertis_llm_tpu/cli.py``).

The JAX package's subcommands, flags and defaults: chat, train,
create-model, create-config, eval, data-pipeline, create-pipeline-config.
Each runs on the card unless told otherwise: ``chat --device``, ``eval
--device`` and ``create-model --device`` (the last two the port's additions
to the parser) name another device, ``train`` reads
``training_config.device``.
``chat`` serves the model in the checkpoint's dtype (f32 from
``load_pretrained``), or int8 with ``--quantize int8``, and prints each reply
as it streams (``ApertisInterface.chat(stream=True)``, through
``InferenceEngine.stream``). ``data-pipeline`` and
``create-pipeline-config`` raise ``NotImplementedError``: the data pipeline
is not ported yet (ROADMAP.md, queue 1). The JAX package's compile cache
(``maybe_enable_cache``) is TPU-only and has no counterpart here.

Run as ``apertis-torch <subcommand>`` or ``python -m apertis_llm_torch.cli``.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import sys

logging.basicConfig(
    level=logging.INFO,
    format="%(asctime)s - %(name)s - %(levelname)s - %(message)s")
logger = logging.getLogger("apertis")


def chat_command(args):
    from apertis_llm_torch.inference.interface import ApertisInterface

    interface = ApertisInterface(
        model_path=args.model_path,
        vocab_file=args.vocab_file,
        multimodal=args.multimodal,
        device=args.device,
        web=args.web,
        port=args.port,
        quantize=args.quantize,
        mesh_shape=([int(x) for x in args.mesh_shape.split(",")]
                    if args.mesh_shape else None),
    )
    if args.web:
        return interface
    print("Apertis CLI Chat Interface")
    print("Type 'exit' to quit, 'reset' to reset chat history")
    while True:
        try:
            user_input = input("\nYou: ")
        except EOFError:
            break
        if user_input.lower() == "exit":
            break
        if user_input.lower() == "reset":
            interface.reset_chat()
            print("Chat history reset")
            continue
        print("\nApertis: ", end="", flush=True)
        shown = ""
        for text in interface.chat(message=user_input, image_path=args.image,
                                   max_length=args.max_length,
                                   temperature=args.temperature, top_k=args.top_k,
                                   top_p=args.top_p, stream=True):
            # The reply's text grows a token at a time; print what is new.
            print(text[len(shown):] if text.startswith(shown) else "\n" + text,
                  end="", flush=True)
            shown = text
        print()
    return interface


def train_command(args):
    from apertis_llm_torch.training import train_from_config

    if not os.path.exists(args.config):
        logger.error("Config file not found: %s", args.config)
        sys.exit(1)
    logger.info("Starting training with config: %s", args.config)
    metrics = train_from_config(args.config)
    print("\nTraining completed!")
    print("Metrics:")
    print(json.dumps(metrics, indent=2, default=str))
    return metrics


def create_model_files(config, output_dir: str, seed: int = 0, device=None) -> int:
    """Initialise ``config``'s model from ``seed`` on ``device`` (the card
    unless named) and write it to ``output_dir`` as ``model.pt`` and
    ``config.json``, beside a minimal ``vocab.json`` unless one is there;
    returns the estimated parameter count."""
    import torch

    from apertis_llm_torch.models.convert import save_torch_checkpoint
    from apertis_llm_torch.models.factory import estimate_model_parameters
    from apertis_llm_torch.models.params import init_params, resolve_device
    from apertis_llm_torch.utils.vocab import create_minimal_vocab_file

    dev = resolve_device(device if device is not None else "cuda")
    params = init_params(config, torch.Generator(device=dev).manual_seed(seed), device=dev)
    os.makedirs(output_dir, exist_ok=True)
    save_torch_checkpoint(params, config, output_dir, filename="model.pt")
    vocab_path = os.path.join(output_dir, "vocab.json")
    if not os.path.exists(vocab_path):
        create_minimal_vocab_file(vocab_path, size=4)
    return estimate_model_parameters(config)


def create_model_command(args):
    from apertis_llm_torch.models.factory import build_model_config

    vocab_size = args.vocab_size if args.vocab_size is not None else 32000
    config_overrides = {}
    if args.expert_system:
        config_overrides.update({
            "num_experts": args.num_experts,
            "experts_per_token": min(args.experts_per_token, args.num_experts),
            "load_balancing_loss_coef": args.load_balancing_loss_coef,
            "expert_capacity_factor": args.expert_capacity_factor,
            "noisy_routing_alpha": args.noisy_routing_alpha,
            "expert_dropout_prob": args.expert_dropout_prob,
            "router_z_loss_coef": args.router_z_loss_coef,
            "use_noisy_top_k_routing": args.use_noisy_top_k_routing,
            "use_expert_capacity_limit": args.use_expert_capacity_limit,
            "use_expert_dropout": args.use_expert_dropout,
            "use_router_z_loss": args.use_router_z_loss,
            "use_load_balancing_loss": args.use_load_balancing_loss,
        })
    if args.attention_type:
        config_overrides["attention_type"] = args.attention_type

    config = build_model_config(
        target_param_count=args.target_params,
        vocab_size_override=vocab_size,
        multimodal=args.multimodal,
        use_flash_attention=args.flash_attention,
        use_expert_system=args.expert_system,
        config_overrides=config_overrides,
    )
    actual = create_model_files(config, args.output_dir, seed=args.seed, device=args.device)
    vocab_path = os.path.join(args.output_dir, "vocab.json")
    print("Model created successfully!")
    print(f"- Target Parameters: {args.target_params}")
    print(f"- Estimated Actual Parameters: {actual:,} (~{actual/1e6:.2f}M)")
    print(f"- Model saved to: {os.path.join(args.output_dir, 'model.pt')}")
    print(f"- Config saved to: {os.path.join(args.output_dir, 'config.json')}")
    print(f"  - Hidden Size: {config.hidden_size}")
    print(f"  - Num Layers: {config.num_hidden_layers}")
    print(f"  - Num Heads: {config.num_attention_heads}")
    print(f"  - Intermediate Size: {config.intermediate_size}")
    print(f"  - Vocab Size: {config.vocab_size}")
    if config.use_expert_system:
        print(f"  - Experts: {config.num_experts}, Per Token: {config.experts_per_token}")
    print(f"- Minimal vocabulary saved to: {vocab_path}")
    return config


def eval_command(args):
    from apertis_llm_torch.evaluation import run_eval

    result = run_eval(
        model_path=args.model_path,
        data_path=args.data,
        task=args.task,
        tokenizer_path=args.vocab_file,
        batch_size=args.batch_size,
        max_items=args.max_items,
        prompt_template=args.prompt_template,
        window=args.window,
        overlap=args.overlap,
        quantize=args.quantize,
        mesh_shape=([int(x) for x in args.mesh_shape.split(",")]
                    if args.mesh_shape else None),
        device=args.device,
    )
    print(json.dumps(result, indent=2))
    return result


def create_config_command(args):
    from apertis_llm_torch.training.pipeline import create_sample_config

    create_sample_config(args.output)
    print(f"Sample training configuration created at: {args.output}")
    print("Edit this file to customize your training settings.")


def data_pipeline_command(args):
    raise NotImplementedError(
        "the data pipeline (data-pipeline) is not ported to PyTorch yet (see ROADMAP.md, "
        "queue 1: the next slice)")


def create_pipeline_config_command(args):
    raise NotImplementedError(
        "the data pipeline's sample configuration (create-pipeline-config) is not ported "
        "to PyTorch yet (see ROADMAP.md, queue 1: the next slice)")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="Apertis CLI - PyTorch/CUDA port of the Apertis LLM framework",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    chat = sub.add_parser("chat", help="Chat with an Apertis model")
    chat.add_argument("--model-path", type=str)
    chat.add_argument("--vocab-file", type=str)
    chat.add_argument("--multimodal", action="store_true")
    chat.add_argument("--image", type=str)
    chat.add_argument("--device", type=str)
    chat.add_argument("--quantize", type=str, choices=["int8"],
                      help="weight-only int8 serving (vision subtree and "
                           "routers stay full precision)")
    chat.add_argument("--mesh-shape", type=str,
                      help="multi-chip serving mesh, e.g. '1,4,1' = "
                           "(data, model/TP, expert); not ported yet")
    chat.add_argument("--web", action="store_true")
    chat.add_argument("--port", type=int, default=7860)
    chat.add_argument("--share", action="store_true")
    chat.add_argument("--max-length", type=int, default=100)
    chat.add_argument("--temperature", type=float, default=0.7)
    chat.add_argument("--top-k", type=int, default=50)
    chat.add_argument("--top-p", type=float, default=0.9)

    train = sub.add_parser("train", help="Train an Apertis model")
    train.add_argument("--config", type=str, required=True)

    create = sub.add_parser("create-model",
                            help="Create a new model from a target parameter count")
    create.add_argument("--target-params", type=str, default="125M")
    create.add_argument("--vocab-size", type=int)
    create.add_argument("--multimodal", action="store_true")
    create.add_argument("--flash-attention", action="store_true")
    create.add_argument("--attention-type", type=str,
                        choices=["standard_mha", "selective_ssm", "selective_linear"])
    create.add_argument("--output-dir", type=str, default="models/new_param_model")
    create.add_argument("--seed", type=int, default=0)
    create.add_argument("--device", type=str,
                        help="device to initialise the weights on (default: the card)")
    moe = create.add_argument_group("MoE Configuration")
    _bool = lambda x: str(x).lower() == "true"  # noqa: E731
    moe.add_argument("--expert-system", action="store_true")
    moe.add_argument("--num-experts", type=int, default=8)
    moe.add_argument("--experts-per-token", type=int, default=2)
    moe.add_argument("--load-balancing-loss-coef", type=float, default=0.01)
    moe.add_argument("--expert-capacity-factor", type=float, default=1.25)
    moe.add_argument("--noisy-routing-alpha", type=float, default=0.1)
    moe.add_argument("--expert-dropout-prob", type=float, default=0.1)
    moe.add_argument("--router-z-loss-coef", type=float, default=0.001)
    moe.add_argument("--use-noisy-top-k-routing", type=_bool, default=True)
    moe.add_argument("--use-expert-capacity-limit", type=_bool, default=True)
    moe.add_argument("--use-expert-dropout", type=_bool, default=True)
    moe.add_argument("--use-router-z-loss", type=_bool, default=True)
    moe.add_argument("--use-load-balancing-loss", type=_bool, default=True)

    ev = sub.add_parser("eval", help="Evaluate a model (perplexity / multiple choice)")
    ev.add_argument("--model-path", type=str, required=True)
    ev.add_argument("--data", type=str, required=True,
                    help="JSONL: {text} for perplexity, "
                         "{question, choices, answer} for multiple_choice")
    ev.add_argument("--task", type=str, default="perplexity",
                    choices=["perplexity", "multiple_choice"])
    ev.add_argument("--vocab-file", type=str)
    ev.add_argument("--batch-size", type=int, default=8)
    ev.add_argument("--max-items", type=int)
    ev.add_argument("--prompt-template", type=str,
                    default="Question: {question}\nAnswer:",
                    help="multiple_choice prompt; '{question}' scores the "
                         "question text verbatim")
    ev.add_argument("--window", type=int, default=2048,
                    help="perplexity: max scored window (cap 2048, the "
                         "largest bucket); longer documents "
                         "slide with `--overlap` context tokens re-read")
    ev.add_argument("--overlap", type=int, default=256,
                    help="context tokens re-read per slide; must be < window")
    ev.add_argument("--quantize", type=str, choices=["int8"],
                    help="score with weight-only int8 weights")
    ev.add_argument("--mesh-shape", type=str,
                    help="TP/EP serving mesh for scoring, e.g. '1,4,1'; not ported yet")
    ev.add_argument("--device", type=str,
                    help="device to score on (default: the card)")

    cfg = sub.add_parser("create-config", help="Create a sample training configuration")
    cfg.add_argument("--output", type=str, default="config.json")

    pipe = sub.add_parser("data-pipeline", help="Run the data processing pipeline")
    pipe.add_argument("--config", type=str, required=True)

    pcfg = sub.add_parser("create-pipeline-config",
                          help="Create a sample data pipeline configuration")
    pcfg.add_argument("--output", type=str, default="pipeline_config.yaml")
    return parser


COMMANDS = {
    "chat": chat_command,
    "train": train_command,
    "create-model": create_model_command,
    "create-config": create_config_command,
    "data-pipeline": data_pipeline_command,
    "create-pipeline-config": create_pipeline_config_command,
    "eval": eval_command,
}


def main(argv=None):
    """Run the subcommand of ``argv`` (default: the process's arguments);
    returns what it returns (the chat's interface, the eval's result, the
    training's metrics, the created model's config)."""
    args = build_parser().parse_args(argv)
    return COMMANDS[args.command](args)


def console_main() -> None:
    """The ``apertis-torch`` console script: :func:`main`, whose result a
    script's exit status must not carry."""
    main()


if __name__ == "__main__":
    console_main()
