"""The mmsft optimizer (counterpart of llamole_tpu/train/trainer.py
create_optimizer): AdamW under global-norm clipping, wrapped in gradient
accumulation, with the learning-rate schedules in closed form.

The JAX package builds it from optax:

    MultiSteps(chain(clip_by_global_norm(max_grad_norm),
                     adamw(schedule, b1, b2, eps, weight_decay)), k)

and this module does the same arithmetic on torch tensors, in the same
order: the micro-step gradients are averaged over the window of k
(optax's running mean acc += (g - acc) / (n + 1)); on the k-th the mean
is clipped to max_grad_norm when its global norm exceeds it, Adam's
moments are updated and bias-corrected, weight decay is added to the
update (decoupled, as optax's add_decayed_weights), and the parameters
move by -schedule(count) * update, count being the number of updates
before this one (so a warmup schedule gives lr 0 at the first update).
The custom optimizers of llamole_tpu/train/optimizers.py (GaLore, LoRA+,
BAdam) are not ported.
"""

import math
from typing import Callable, Dict

import torch

Schedule = Callable[[int], float]


def wants_custom_optimizer(finetuning_args) -> bool:
    return bool(finetuning_args is not None and (
        getattr(finetuning_args, "use_galore", False)
        or getattr(finetuning_args, "use_badam", False)
        or getattr(finetuning_args, "loraplus_lr_ratio", None)))


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.linear_schedule."""
    def f(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _cosine_decay(init: float, steps: int) -> Schedule:
    """optax.cosine_decay_schedule with alpha 0."""
    def f(count: int) -> float:
        c = min(max(count, 0), steps)
        return init * 0.5 * (1.0 + math.cos(math.pi * c / steps))
    return f


def _join(first: Schedule, second: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules of two pieces."""
    def f(count: int) -> float:
        return first(count) if count < boundary else second(count - boundary)
    return f


def warmup_cosine_decay_schedule(peak: float, warmup_steps: int,
                                 decay_steps: int) -> Schedule:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup_steps,
    decay_steps): linear warmup from 0, then cosine decay to 0."""
    return _join(_linear(0.0, peak, warmup_steps),
                 _cosine_decay(peak, max(decay_steps - warmup_steps, 1)),
                 warmup_steps)


def make_schedule(args, num_training_steps: int) -> Schedule:
    """The learning rate at each optimizer update (counted from 0), as
    create_optimizer builds it: warmup then cosine decay to 0, warmup
    then linear decay to 0, or constant."""
    lr = args.learning_rate
    warmup = args.warmup_steps or int(args.warmup_ratio * num_training_steps)
    if args.lr_scheduler_type == "cosine":
        # optax.warmup_cosine_decay_schedule(0, lr, w, max(n, w + 1))
        w = max(warmup, 1)
        return warmup_cosine_decay_schedule(
            lr, w, max(num_training_steps, w + 1))
    if args.lr_scheduler_type == "linear":
        w = max(warmup, 1)
        return _join(_linear(0.0, lr, w),
                     _linear(lr, 0.0, max(num_training_steps - warmup, 1)), w)
    return lambda count: lr


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (f32)."""
    return torch.sqrt(sum((t.float() * t.float()).sum() for t in tensors))


class AccumulatingAdamW:
    """optax.MultiSteps(chain(clip_by_global_norm, adamw)) over named
    parameters. `accumulate()` takes each parameter's .grad of one micro
    step and returns True when it completed a window and updated the
    parameters."""

    def __init__(self, params: Dict[str, torch.nn.Parameter],
                 schedule: Schedule, *, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0,
                 max_grad_norm: float = 1.0, accumulation_steps: int = 1):
        self.params = params
        self.schedule = schedule
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.k = max(int(accumulation_steps), 1)
        self.count = 0        # updates applied
        self.mini_step = 0    # micro steps in the current window
        self.acc = {n: torch.zeros_like(p) for n, p in params.items()}
        self.mu = {n: torch.zeros_like(p) for n, p in params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in params.items()}

    @torch.no_grad()
    def accumulate(self) -> bool:
        n_acc = self.mini_step
        for name, p in self.params.items():
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            acc = self.acc[name]
            acc.add_((g.to(acc.dtype) - acc) / (n_acc + 1))
        self.mini_step += 1
        if self.mini_step < self.k:
            return False
        self._update()
        self.mini_step = 0
        for acc in self.acc.values():
            acc.zero_()
        return True

    def _update(self) -> None:
        grads = self.acc
        norm = global_norm(grads.values())
        clip = bool(norm >= self.max_grad_norm)
        lr = self.schedule(self.count)
        self.count += 1
        c1 = 1.0 - self.b1 ** self.count
        c2 = 1.0 - self.b2 ** self.count
        for name, p in self.params.items():
            g = grads[name]
            if clip:
                g = g / norm.to(g.dtype) * self.max_grad_norm
            mu, nu = self.mu[name], self.nu[name]
            mu.mul_(self.b1).add_((1.0 - self.b1) * g)
            nu.mul_(self.b2).add_((1.0 - self.b2) * g * g)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p
            p.add_(update.to(p.dtype), alpha=-lr)


def create_optimizer(args, num_training_steps: int,
                     params: Dict[str, torch.nn.Parameter],
                     finetuning_args=None):
    """(optimizer, schedule) from TrainingArguments; num_training_steps
    counts optimizer updates."""
    if wants_custom_optimizer(finetuning_args):
        raise NotImplementedError(
            "GaLore / LoRA+ / BAdam optimizers are not ported to "
            "llamole_tpu_torch yet (ROADMAP.md)")
    schedule = make_schedule(args, num_training_steps)
    opt = AccumulatingAdamW(
        params, schedule, b1=args.adam_beta1, b2=args.adam_beta2,
        eps=args.adam_epsilon, weight_decay=args.weight_decay,
        max_grad_norm=args.max_grad_norm,
        accumulation_steps=args.gradient_accumulation_steps)
    return opt, schedule
