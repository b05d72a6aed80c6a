"""ApertisTrainer: the training loop on one device (``apertis_llm_tpu/
training/trainer.py``).

The JAX trainer's signature and loop: AdamW with the one-cycle cosine
schedule, gradient accumulation and clipping, an eval loop with a best-val
weights-only checkpoint, per-epoch / per-step / per-iteration / final
checkpoints, a cooperative ``stop_event``, optional wandb, epoch throughput
statistics (``tokens_per_sec``, ``step_time_wall_s``, ``mfu_pct``), a full
resume (``resume_from``) and a ``torch.profiler`` trace over
``profile_steps``. bf16 compute keeps f32 masters; ``remat`` is per-layer
``torch.utils.checkpoint``.

The model runs on one device, the card unless ``device`` names another.
Not ported yet, and refused with ``NotImplementedError`` (ROADMAP.md, module
7): a mesh beyond one device, pipeline stages, a ``seq`` or ``expert`` axis.
``dynamic_batch_sizing`` is a logged no-op, as in the JAX trainer.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from apertis_llm_torch.config import ApertisConfig
from apertis_llm_torch.models.apertis import fold_seed
from apertis_llm_torch.models.convert import from_jax_params
from apertis_llm_torch.models.params import check_trainable, quantized_layout
from apertis_llm_torch.training.datasets import BatchLoader
from apertis_llm_torch.training.step import decay_mask, eval_step, make_optimizer, train_step
from apertis_llm_torch.utils.checkpoint import restore_train_state, save_checkpoint
from apertis_llm_torch.utils.profiling import (
    StepTimer, device_peak_tflops, start_trace, stop_trace)

logger = logging.getLogger(__name__)


class ApertisTrainer:
    def __init__(
        self,
        config: ApertisConfig,
        params: Dict[str, Any],
        train_dataset,
        val_dataset=None,
        output_dir: str = "output",
        batch_size: int = 4,
        learning_rate: float = 5e-5,
        weight_decay: float = 0.01,
        num_epochs: int = 3,
        warmup_steps: int = 0,
        gradient_accumulation_steps: int = 4,
        max_grad_norm: float = 1.0,
        use_wandb: bool = False,
        wandb_project: str = "apertis",
        wandb_run_name: Optional[str] = None,
        bf16: bool = True,
        checkpoint_steps: int = 0,
        iteration_checkpoint_steps: int = 0,
        use_gradient_checkpointing: bool = True,
        eval_every_n_epochs: int = 1,
        dynamic_batch_sizing: bool = True,
        mesh_shape=None,
        stop_event: Optional[threading.Event] = None,
        is_fine_tuning: bool = False,
        tokenizer_path_to_save: Optional[str] = None,
        seed: int = 0,
        resume_from: Optional[str] = None,
        profile_dir: Optional[str] = None,
        profile_steps: Tuple[int, int] = (10, 15),
        pipeline_stages: int = 0,
        pipeline_microbatches: int = 0,
        pipeline_schedule: str = "gpipe",
        device="cuda",
        save_checkpoints: bool = True,
    ):
        """``params`` is a parameter tree named like the JAX package's (from
        either package's ``init_params``, or numpy); it is copied into an f32
        model on ``device``. ``warmup_steps``, ``pipeline_microbatches`` and
        ``pipeline_schedule`` are accepted as the JAX trainer accepts them
        (the schedule's warm-up is its ``pct_start``). The port's own
        arguments: ``device``, and ``save_checkpoints=False`` for a
        measurement run that writes no checkpoint."""
        self.config = config.replace(remat=use_gradient_checkpointing)
        self.device = torch.device(device)
        self.compute_dtype = torch.bfloat16 if bf16 else None
        if pipeline_stages > 1:
            raise NotImplementedError(
                "pipeline_stages > 1 is not ported to PyTorch yet (see ROADMAP.md)")
        # A mesh of more than one device (data, model, expert or seq axis).
        devices = int(np.prod(mesh_shape)) if mesh_shape is not None else 1
        check_trainable(self.config, quantized_layout(params), self.device, self.compute_dtype,
                        devices)
        self.train_dataset = train_dataset
        self.val_dataset = val_dataset
        self.output_dir = Path(output_dir)
        self.batch_size = batch_size
        self.num_epochs = num_epochs
        self.gradient_accumulation_steps = max(1, gradient_accumulation_steps)
        self.eval_every_n_epochs = max(1, eval_every_n_epochs)
        self.checkpoint_steps = checkpoint_steps
        self.iteration_checkpoint_steps = iteration_checkpoint_steps
        self.stop_event = stop_event or threading.Event()
        self.is_fine_tuning = is_fine_tuning
        self.tokenizer_path_to_save = tokenizer_path_to_save
        self.use_wandb = use_wandb
        self.profile_dir = profile_dir
        self.profile_steps = profile_steps
        self.seed = seed
        self.save_checkpoints = save_checkpoints
        self.micro_step = 0          # micro-steps taken, the stream of step seeds
        if dynamic_batch_sizing:
            logger.info("dynamic_batch_sizing requested: batches have one static shape; "
                        "the flag is a no-op here.")

        self.train_loader = BatchLoader(
            train_dataset, batch_size, shuffle=True, drop_last=True, seed=seed)
        self.val_loader = (BatchLoader(val_dataset, batch_size, shuffle=False,
                                       drop_last=False, seed=seed)
                           if val_dataset is not None else None)
        steps_per_epoch = max(
            1, -(-len(self.train_loader) // self.gradient_accumulation_steps))
        total_steps = steps_per_epoch * num_epochs

        self.model = from_jax_params(params, self.config, device=self.device,
                                     dtype=torch.float32)
        self.optimizer, self.schedule = make_optimizer(
            dict(self.model.named_parameters()), decay_mask(self.model), learning_rate,
            total_steps, weight_decay, max_grad_norm, self.gradient_accumulation_steps)
        if resume_from:
            logger.info("Resuming full train state from %s", resume_from)
            self.load_train_state(restore_train_state(resume_from, self.device))

        self._wandb = None
        if self.use_wandb:
            try:
                import wandb

                wandb.init(project=wandb_project, name=wandb_run_name,
                           config={"batch_size": batch_size,
                                   "learning_rate": learning_rate,
                                   "model_config": self.config.to_dict()})
                self._wandb = wandb
            except ImportError:
                logger.warning("wandb not installed; disabling wandb logging.")
                self.use_wandb = False

    # ------------------------------------------------------------------
    def train_state(self) -> Dict[str, Any]:
        """What ``state.pt`` keeps beside the model's weights."""
        return {"optimizer": self.optimizer.state_dict(), "step": self.optimizer.count,
                "micro_step": self.micro_step, "seed": self.seed}

    @torch.no_grad()
    def load_train_state(self, state: Dict[str, Any]) -> None:
        self.model.load_state_dict(state["model"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.micro_step, self.seed = int(state["micro_step"]), int(state["seed"])

    def _put_batch(self, batch: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(v, dtype=torch.long).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def save_checkpoint(self, name: str, full_state: bool = True) -> None:
        if not self.save_checkpoints:
            return
        save_checkpoint(self.output_dir / name, self.model, self.config,
                        train_state=self.train_state(),
                        tokenizer_src=self.tokenizer_path_to_save, full_state=full_state)

    def evaluate(self) -> Optional[float]:
        if self.val_loader is None:
            return None
        losses, counts = [], []
        for batch in self.val_loader:
            n = batch["input_ids"].shape[0]
            pad = -n % self.batch_size
            if pad:
                batch = {k: np.concatenate([v, np.repeat(v[-1:], pad, axis=0)])
                         for k, v in batch.items()}
            metrics = eval_step(self.model, self._put_batch(batch), self.compute_dtype)
            losses.append(float(metrics["loss"]))
            counts.append(n)
        if not losses:
            return None
        return float(np.average(losses, weights=counts))

    def train(self) -> Dict[str, Any]:
        logger.info("Starting %s on %s", "fine-tuning" if self.is_fine_tuning else "pre-training",
                    self.device)
        best_val = float("inf")
        global_step = self.optimizer.count
        history: Dict[str, Any] = {"train_loss": [], "val_loss": []}
        timer = StepTimer()
        prof = None
        tokens_per_step = self.batch_size * getattr(self.train_dataset, "max_length", 0)
        # MFU: 6N model FLOPs a token (remat's recompute not counted; all
        # parameters, the tied embedding included) against the card's dense
        # bf16 peak; skipped where the peak is unknown (the CPU).
        peak_tflops = device_peak_tflops()
        n_model_params = sum(p.numel() for p in self.model.parameters()) if peak_tflops else 0
        # Device-to-host fetch cadence: 1 syncs every micro-step (for
        # measurement); the default keeps the steps queued on the device.
        sync_every = int(os.environ.get("APERTIS_TRAINER_SYNC_EVERY", "100"))

        for epoch in range(self.num_epochs):
            if self.stop_event.is_set():
                logger.info("Stop event received; halting at epoch %d.", epoch + 1)
                break
            self.train_loader.set_epoch(epoch)
            epoch_losses = []
            device_losses = []
            t0 = time.time()
            for step, batch in enumerate(self.train_loader):
                if self.stop_event.is_set():
                    break
                if self.profile_dir and epoch == 0:
                    if step == self.profile_steps[0] and prof is None:
                        prof = start_trace()
                    elif step == self.profile_steps[1] and prof is not None:
                        stop_trace(prof, self.profile_dir)
                        prof = None
                metrics = train_step(self.model, self.optimizer, self._put_batch(batch),
                                     fold_seed(self.seed, self.micro_step), self.compute_dtype)
                self.micro_step += 1
                device_losses.append(metrics["loss"])
                timer.tick()
                if len(device_losses) >= sync_every:
                    epoch_losses.extend(torch.stack(device_losses).tolist())
                    device_losses = []
                if (step + 1) % self.gradient_accumulation_steps == 0:
                    global_step += 1
                    if self._wandb:
                        # The one per-step consumer of host values (off by default).
                        self._wandb.log({
                            "train/loss": float(metrics["loss"]),
                            "train/learning_rate": self.schedule(global_step),
                            "train/grad_norm": float(metrics["grad_norm"]),
                            "train/epoch_progress":
                                epoch + (step + 1) / max(len(self.train_loader), 1),
                        })
                    if self.checkpoint_steps and global_step % self.checkpoint_steps == 0:
                        self.save_checkpoint(f"checkpoint-step-{global_step}")
                if (self.iteration_checkpoint_steps
                        and (step + 1) % self.iteration_checkpoint_steps == 0):
                    self.save_checkpoint(f"checkpoint-iter-{step + 1}")
            if prof is not None:
                stop_trace(prof, self.profile_dir)
                prof = None

            if device_losses:
                epoch_losses.extend(torch.stack(device_losses).tolist())
            mean_loss = float(np.mean(epoch_losses)) if epoch_losses else float("nan")
            history["train_loss"].append(mean_loss)
            history.setdefault("step_losses", []).extend(epoch_losses)
            # Throughput from the epoch's wall time after the loss fetch above,
            # which waits for the queued steps; the per-tick timer sees only
            # the time to queue them.
            elapsed = time.time() - t0
            stats = timer.stats(tokens_per_step or None)
            n_steps = len(epoch_losses)
            if n_steps and elapsed > 0:
                stats["epoch_time_s"] = elapsed
                stats["step_time_wall_s"] = elapsed / n_steps
                if tokens_per_step:
                    stats["tokens_per_sec"] = tokens_per_step * n_steps / elapsed
                    if peak_tflops and n_model_params:
                        stats["mfu_pct"] = (stats["tokens_per_sec"] * 6.0 * n_model_params
                                            / (peak_tflops * 1e12) * 100.0)
            mfu_txt = f", {stats['mfu_pct']:.1f}% MFU" if "mfu_pct" in stats else ""
            logger.info("Epoch %d/%d: loss=%.4f (%.1fs)%s", epoch + 1, self.num_epochs,
                        mean_loss, elapsed,
                        f"  [{stats.get('tokens_per_sec', 0):,.0f} tok/s, "
                        f"{stats.get('step_time_wall_s', 0) * 1e3:.0f} ms/step wall{mfu_txt}]"
                        if stats else "")
            if stats:
                history["perf"] = dict(stats)
            if self._wandb and stats:
                self._wandb.log({f"perf/{k}": v for k, v in stats.items()})

            if (epoch + 1) % self.eval_every_n_epochs == 0:
                val_loss = self.evaluate()
                if val_loss is not None:
                    history["val_loss"].append(val_loss)
                    logger.info("Epoch %d validation loss: %.4f", epoch + 1, val_loss)
                    if self._wandb:
                        self._wandb.log({"val/loss": val_loss})
                    if val_loss < best_val:
                        best_val = val_loss
                        # Weights only: best_model is an inference artifact;
                        # resume state lives in the epoch/step checkpoints.
                        self.save_checkpoint("best_model", full_state=False)
            if not self.stop_event.is_set():
                self.save_checkpoint(f"checkpoint-epoch-{epoch + 1}")

        self.save_checkpoint("final")
        if self._wandb:
            self._wandb.finish()
        history["final_step"] = global_step
        history["best_val_loss"] = best_val if best_val != float("inf") else None
        return history
