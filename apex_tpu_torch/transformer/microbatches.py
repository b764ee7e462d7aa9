"""Microbatch calculator (global-batch bookkeeping, incl. rampup).

Counterpart of ``apex_tpu/transformer/microbatches.py``, the same
plain-Python bookkeeping (the port keeps its own copy).

Reference: ``apex/transformer/microbatches.py`` +
``apex/transformer/pipeline_parallel/utils.py`` —
``setup_microbatch_calculator(rank, rampup_batch_size,
global_batch_size, micro_batch_size, data_parallel_size)``,
``get_num_microbatches()``, ``get_current_global_batch_size()``,
``update_num_microbatches(consumed_samples)``.

Plain python config math (host-side; never traced), reused verbatim in
spirit: num_microbatches = global_batch // (micro_batch * dp_size), with
an optional linear batch-size rampup schedule.
"""

from __future__ import annotations

from typing import List, Optional, Union

__all__ = [
    "build_num_microbatches_calculator",
    "setup_microbatch_calculator",
    "get_num_microbatches",
    "get_current_global_batch_size",
    "update_num_microbatches",
    "ConstantNumMicroBatches",
    "RampupBatchsizeNumMicroBatches",
    "destroy_microbatch_calculator",
]

_CALCULATOR = None


class ConstantNumMicroBatches:
    """Fixed global batch size."""

    def __init__(self, global_batch_size: int, micro_batch_size: int,
                 data_parallel_size: int):
        per_step = micro_batch_size * data_parallel_size
        if global_batch_size % per_step:
            raise ValueError(
                f"global_batch_size ({global_batch_size}) must be "
                f"divisible by micro_batch_size * data_parallel_size "
                f"({micro_batch_size} * {data_parallel_size})")
        self.num_micro_batches = global_batch_size // per_step
        self.current_global_batch_size = global_batch_size
        self.micro_batch_size = micro_batch_size

    def get(self) -> int:
        return self.num_micro_batches

    def get_current_global_batch_size(self) -> int:
        return self.current_global_batch_size

    def update(self, consumed_samples: int,
               consistency_check: bool = True) -> None:
        pass


class RampupBatchsizeNumMicroBatches(ConstantNumMicroBatches):
    """Linear global-batch rampup: start → global over ramp samples.

    Reference semantics: batch size increments in steps of
    ``increment``; each size holds for an equal share of
    ``ramup_samples`` consumed samples.
    """

    def __init__(self, start_batch_size: int, batch_size_increment: int,
                 ramup_samples: int, global_batch_size: int,
                 micro_batch_size: int, data_parallel_size: int):
        super().__init__(global_batch_size, micro_batch_size,
                         data_parallel_size)
        self.micro_batch_times_data_parallel_size = (
            micro_batch_size * data_parallel_size)
        diff = global_batch_size - start_batch_size
        if diff < 0 or (batch_size_increment <= 0 and diff > 0) \
                or (batch_size_increment > 0
                    and diff % batch_size_increment):
            raise ValueError(
                f"cannot ramp {start_batch_size} -> {global_batch_size} "
                f"in increments of {batch_size_increment}")
        if start_batch_size % self.micro_batch_times_data_parallel_size:
            raise ValueError("start batch size must be divisible by "
                             "micro_batch_size * data_parallel_size")
        self.start_batch_size = start_batch_size
        self.batch_size_increment = batch_size_increment
        self.ramup_samples = ramup_samples
        self.global_batch_size = global_batch_size
        num_increments = diff // batch_size_increment if \
            batch_size_increment else 0
        self.rampup_samples_per_increment = (
            ramup_samples / num_increments if num_increments else 0)
        self.update(0, False)

    def update(self, consumed_samples: int,
               consistency_check: bool = True) -> None:
        if (self.rampup_samples_per_increment == 0
                or consumed_samples > self.ramup_samples):
            gbs = self.global_batch_size
        else:
            steps = int(consumed_samples /
                        self.rampup_samples_per_increment)
            gbs = (self.start_batch_size
                   + steps * self.batch_size_increment)
            gbs = min(gbs, self.global_batch_size)
        if consistency_check and \
                gbs % self.micro_batch_times_data_parallel_size:
            raise ValueError(
                f"ramped batch size {gbs} not divisible by "
                f"micro*dp {self.micro_batch_times_data_parallel_size}")
        self.current_global_batch_size = gbs
        self.num_micro_batches = (
            gbs // self.micro_batch_times_data_parallel_size)


def build_num_microbatches_calculator(
    rampup_batch_size: Optional[Union[List[int], tuple]],
    global_batch_size: int,
    micro_batch_size: int,
    data_parallel_size: int,
):
    """Constant or rampup calculator from the reference's
    ``rampup_batch_size = [start, increment, ramp_samples]`` spec."""
    if rampup_batch_size is None:
        return ConstantNumMicroBatches(
            global_batch_size, micro_batch_size, data_parallel_size)
    if len(rampup_batch_size) != 3:
        raise ValueError(
            "rampup_batch_size = [start, increment, ramp_samples]")
    start, inc, samples = (int(v) for v in rampup_batch_size)
    return RampupBatchsizeNumMicroBatches(
        start, inc, samples, global_batch_size, micro_batch_size,
        data_parallel_size)


def setup_microbatch_calculator(
    rank: int = 0,
    rampup_batch_size: Optional[list] = None,
    global_batch_size: int = 1,
    micro_batch_size: int = 1,
    data_parallel_size: int = 1,
) -> None:
    """Install the global calculator (reference-compatible signature;
    ``rank`` only gated logging upstream)."""
    global _CALCULATOR
    _CALCULATOR = build_num_microbatches_calculator(
        rampup_batch_size, global_batch_size, micro_batch_size,
        data_parallel_size)


def _get():
    if _CALCULATOR is None:
        raise RuntimeError("call setup_microbatch_calculator(...) first")
    return _CALCULATOR


def get_num_microbatches() -> int:
    """Current number of microbatches from the global calculator
    (reference: ``apex.transformer.pipeline_parallel.utils``)."""
    return _get().get()


def get_current_global_batch_size() -> int:
    """Current global batch size (rampup-aware), reference name."""
    return _get().get_current_global_batch_size()


def update_num_microbatches(consumed_samples: int,
                            consistency_check: bool = True) -> None:
    """Advance the rampup schedule to ``consumed_samples`` (reference
    name; no-op for the constant calculator)."""
    _get().update(consumed_samples, consistency_check)


def destroy_microbatch_calculator() -> None:
    """Reset the global calculator (test isolation, reference name)."""
    global _CALCULATOR
    _CALCULATOR = None
