"""The port's data pipeline (``accelerate_tpu_torch/data_loader.py``) held
against the JAX package's: every sampler and shard index stream equal
(stride / split modes, ``even_batches`` padding, ``drop_last``, iterable
sharding, the seedable sampler's ``default_rng(seed + epoch)``
permutations), ``skip_first_batches`` and ``state_dict`` resume positions
equal, the loaders' ``GradientState`` signalling, one-batch lookahead,
the ``transfer`` retry, the dispatcher, and a loader-fed 4-step training
trajectory against JAX's at ``test_train_step_trajectory_matches_jax``'s
1e-3 / 5e-3 (the ``across_steps`` accumulation included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.utils.data as tud

from accelerate_tpu import data_loader as jdl
from accelerate_tpu.accelerator import Accelerator as JaxAccelerator
from accelerate_tpu.models import llama as jl
from accelerate_tpu.optimizer import make_optimizer as jax_make_optimizer
from accelerate_tpu.state import AcceleratorState as JaxAcceleratorState
from accelerate_tpu.state import GradientState as JaxGradientState
from accelerate_tpu.utils import dataclasses as jdc
from accelerate_tpu_torch import (
    Accelerator, DataLoaderConfiguration, GradientAccumulationPlugin, LlamaConfig,
    LlamaForCausalLM, make_llama_loss_fn,
)
from accelerate_tpu_torch.models.convert import torch_state_from_flax
from accelerate_tpu_torch import data_loader as tdl
from accelerate_tpu_torch.resilience import FaultEvent, FaultPlan, InjectedTransferError, fault_plan
from accelerate_tpu_torch.resilience.retry import RetryPolicy
from accelerate_tpu_torch.state import GradientState


class SimpleBatchSampler:
    def __init__(self, n, batch_size, drop_last=False):
        self.n, self.batch_size, self.drop_last = n, batch_size, drop_last

    def __iter__(self):
        batch = []
        for i in range(self.n):
            batch.append(i)
            if len(batch) == self.batch_size:
                yield batch
                batch = []
        if batch and not self.drop_last:
            yield batch

    def __len__(self):
        return self.n // self.batch_size if self.drop_last else -(-self.n // self.batch_size)


SHARD_CASES = [(n, bs, procs, split, even, drop)
               for n, bs, procs in ((8, 2, 2), (10, 2, 2), (9, 2, 2), (6, 4, 2), (17, 4, 3),
                                    (23, 3, 4), (5, 4, 2))
               for split in (False, True) for even in (True, False) for drop in (False, True)
               if not (split and bs % procs)]


@pytest.mark.parametrize("n, bs, procs, split, even, drop", SHARD_CASES)
def test_batch_sampler_shard_equals_jax(n, bs, procs, split, even, drop):
    for rank in range(procs):
        kw = dict(num_processes=procs, process_index=rank, split_batches=split, even_batches=even)
        port = tdl.BatchSamplerShard(SimpleBatchSampler(n, bs, drop), **kw)
        ref = jdl.BatchSamplerShard(SimpleBatchSampler(n, bs, drop), **kw)
        assert list(port) == list(ref)
        assert len(port) == len(ref)


def test_stride_and_split_semantics():
    shards = [list(tdl.BatchSamplerShard(SimpleBatchSampler(10, 2), num_processes=2,
                                         process_index=i)) for i in range(2)]
    assert shards[0] == [[0, 1], [4, 5], [8, 9]]
    assert shards[1] == [[2, 3], [6, 7], [0, 1]]   # padded from the epoch's head
    with pytest.raises(ValueError):
        tdl.BatchSamplerShard(SimpleBatchSampler(9, 3), num_processes=2, split_batches=True)


@pytest.mark.parametrize("n, bs, procs, split, drop", [
    (10, 2, 2, False, False), (10, 2, 2, False, True), (13, 3, 3, False, False),
    (12, 4, 2, True, False), (7, 4, 2, True, True)])
def test_iterable_dataset_shard_equals_jax(n, bs, procs, split, drop):
    for rank in range(procs):
        kw = dict(batch_size=bs, num_processes=procs, process_index=rank, split_batches=split,
                  drop_last=drop)
        assert list(tdl.IterableDatasetShard(range(n), **kw)) == \
            list(jdl.IterableDatasetShard(range(n), **kw))
    shard = tdl.IterableDatasetShard(range(10), batch_size=2, num_processes=2, process_index=1)
    assert list(shard) == [2, 3, 6, 7, 0, 1]


def test_seedable_sampler_equals_jax_epoch_by_epoch():
    port, ref = tdl.SeedableRandomSampler(37, seed=42), jdl.SeedableRandomSampler(37, seed=42)
    for epoch in range(3):
        a, b = list(port), list(ref)
        assert a == b == np.random.default_rng(42 + epoch).permutation(37).tolist()
    port.set_epoch(7)
    ref.set_epoch(7)
    assert list(port) == list(ref)


def test_skip_sampler_and_skip_loader_equal_jax():
    assert list(tdl.SkipBatchSampler(SimpleBatchSampler(8, 2), 2)) == \
        list(jdl.SkipBatchSampler(SimpleBatchSampler(8, 2), 2)) == [[4, 5], [6, 7]]
    assert len(tdl.SkipBatchSampler(SimpleBatchSampler(8, 2), 2)) == 2
    batches = [b[0].ravel().tolist() for b in tdl.SkipDataLoader(_torch_loader(), 2)]
    assert batches == [[8, 9, 10, 11], [12, 13, 14, 15]]
    assert len(tdl.SkipDataLoader(_torch_loader(), 2)) == 2


def _torch_loader(n=16, bs=4, shuffle=False):
    data = tud.TensorDataset(torch.arange(n, dtype=torch.float32).reshape(n, 1))
    return tud.DataLoader(data, batch_size=bs, shuffle=shuffle)


def _rows(batches) -> list:
    return [np.asarray(b[0]).ravel().tolist() for b in batches]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_loader_yields_tensors_on_the_device_and_signals(prefetch):
    gs = GradientState()
    dl = tdl.prepare_data_loader(_torch_loader(n=10, bs=4), device="cpu", prefetch_size=prefetch,
                                 gradient_state=gs)
    flags, rems = [], []
    batches = []
    for b in dl:
        batches.append(b)
        flags.append(gs.end_of_dataloader)
        rems.append(gs.remainder)
    assert isinstance(batches[0][0], torch.Tensor) and batches[0][0].device.type == "cpu"
    assert _rows(batches) == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]
    assert flags == [False, False, True] and rems == [2, 2, 2]
    assert not gs.in_dataloader and gs.remainder == -1
    assert (dl.total_batch_size, dl.total_dataset_length, len(dl)) == (4, 10, 3)


def test_seedable_prepare_streams_equal_jax_over_epochs():
    """The index stream of a shuffled torch loader through each package's
    ``prepare_data_loader(use_seedable_sampler=True)``, three epochs."""
    port = tdl.prepare_data_loader(_torch_loader(shuffle=True), device="cpu",
                                   use_seedable_sampler=True, data_seed=7)
    ref = jdl.prepare_data_loader(_torch_loader(shuffle=True), use_seedable_sampler=True,
                                  data_seed=7, put_on_device=False)
    for _ in range(3):
        assert _rows(port) == _rows(ref)


@pytest.mark.parametrize("skip", [0, 1, 3, 4])
def test_skip_first_batches_equals_jax(skip):
    port = tdl.skip_first_batches(tdl.prepare_data_loader(_torch_loader(), device="cpu"), skip)
    ref = jdl.skip_first_batches(jdl.prepare_data_loader(_torch_loader(), put_on_device=False),
                                 skip)
    assert _rows(port) == _rows(ref) and len(port) == len(ref)


@pytest.mark.parametrize("consumed", [0, 2, 3, 4])
def test_state_dict_resume_positions_equal_jax(consumed):
    """Mid-epoch positions, their restore (next pass only) and the roll to
    the next epoch on the pass's last batch, against the JAX loader."""
    loaders = [tdl.prepare_data_loader(_torch_loader(), device="cpu"),
               jdl.prepare_data_loader(_torch_loader(), put_on_device=False)]
    states, rest = [], []
    for dl in loaders:
        it = iter(dl)
        for _ in range(consumed):
            next(it)
        states.append(dl.state_dict())
    assert states[0] == states[1]
    for dl, make in ((tdl.prepare_data_loader(_torch_loader(), device="cpu"), None),
                     (jdl.prepare_data_loader(_torch_loader(), put_on_device=False), None)):
        dl.load_state_dict(states[0])
        rest.append((_rows(dl), _rows(dl), dl.state_dict()))
    assert rest[0] == rest[1]


def test_stateful_resume_epoch_position_not_lifetime():
    dl = tdl.prepare_data_loader(_torch_loader(), device="cpu")
    for _ in range(2):
        assert len(list(dl)) == 4
    assert dl.state_dict() == {"batches_yielded": 0, "iteration": 2}
    dl2 = tdl.prepare_data_loader(_torch_loader(), device="cpu")
    dl2.load_state_dict(dl.state_dict())
    assert len(list(dl2)) == 4


def test_dispatcher_single_process_and_resume():
    dl = tdl.DataLoaderDispatcher(_torch_loader(n=8, bs=4), device="cpu")
    assert _rows(dl) == [[0, 1, 2, 3], [4, 5, 6, 7]]
    live = tdl.DataLoaderDispatcher(_torch_loader(), device="cpu")
    it = iter(live)
    for _ in range(3):
        next(it)
    sd = live.state_dict()
    ref = jdl.DataLoaderDispatcher(_torch_loader())
    it = iter(ref)
    for _ in range(3):
        next(it)
    assert sd == ref.state_dict() == {"batches_yielded": 3, "iteration": 0}
    resumed = tdl.DataLoaderDispatcher(_torch_loader(), device="cpu")
    resumed.load_state_dict(sd)
    assert _rows(resumed) == [[12, 13, 14, 15]]


def test_iterable_torch_dataset_streams_as_in_jax():
    """An iterable dataset takes the JAX package's route (the shard loader:
    torch's ``Dataset`` base defines ``__getitem__``), and the dispatcher
    when asked for; both give the stream."""
    class Stream(tud.IterableDataset):
        def __iter__(self):
            return iter(torch.arange(10, dtype=torch.float32).reshape(10, 1))

    for dispatch in (None, True):
        dl = tdl.prepare_data_loader(tud.DataLoader(Stream(), batch_size=4), device="cpu",
                                     dispatch_batches=dispatch)
        ref = jdl.prepare_data_loader(tud.DataLoader(Stream(), batch_size=4),
                                      dispatch_batches=dispatch)
        assert type(dl).__name__ == type(ref).__name__
        assert [b.ravel().tolist() for b in dl] == [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9]]


@pytest.mark.parametrize("prefetch", [0, 2])
def test_transfer_retry_gives_the_same_stream(prefetch):
    """Two injected staging failures within the budget: the same batches,
    and the retries counted by the accelerator's goodput."""
    acc = Accelerator(cpu=True, dataloader_config=DataLoaderConfiguration(prefetch_size=prefetch))
    acc.resilience_plugin.io_backoff_s = 0.001
    dl = acc.prepare(_torch_loader())
    clean = _rows(dl)
    with fault_plan(FaultPlan([FaultEvent("transfer", at=2, count=2)])):
        faulted = _rows(dl)
    assert faulted == clean
    assert acc.goodput.transfer_retries == 2
    dl2 = tdl.prepare_data_loader(_torch_loader(), device="cpu",
                                  transfer_retry_policy=RetryPolicy(retries=1, backoff_s=0.001))
    with fault_plan(FaultPlan([FaultEvent("transfer", at=1, count=5)])):
        with pytest.raises(InjectedTransferError):
            list(dl2)


def test_gather_for_metrics_drops_the_padded_tail():
    """One process: outside the last batch the data is returned as it is;
    on the loader's last batch only ``remainder`` rows are kept (what a
    padded last batch's duplicates would need), tensors, dicts and lists
    alike."""
    acc = Accelerator(cpu=True)
    dl = acc.prepare(_torch_loader(n=10, bs=4))
    seen = []
    for (x,) in dl:
        padded = torch.cat([x, x[:4 - len(x)]]) if len(x) < 4 else x
        seen.append((len(acc.gather_for_metrics(padded)),
                     len(acc.gather_for_metrics({"p": padded})["p"]),
                     len(acc.gather_for_metrics([padded, padded])[1])))
    assert seen == [(4, 4, 4), (4, 4, 4), (2, 2, 2)]
    assert len(acc.gather_for_metrics(torch.zeros(4))) == 4   # outside a loader


def test_accelerator_prepare_routes_objects():
    from accelerate_tpu_torch import AcceleratedScheduler, LlamaConfig, LlamaForCausalLM
    from accelerate_tpu_torch.optimizer import AcceleratedOptimizer, make_optimizer

    acc = Accelerator(cpu=True)
    model = LlamaForCausalLM(LlamaConfig.tiny(), device="cpu")

    def schedule(step):
        return 1e-3

    schedule.is_schedule = True
    dl, opt, m, sched, other = acc.prepare(_torch_loader(), make_optimizer("adamw"), model,
                                           schedule, lambda x: x)
    assert isinstance(dl, tdl.DataLoaderShard) and acc.prepare(dl) is dl
    assert isinstance(opt, AcceleratedOptimizer) and m is model and acc._models == [model]
    assert isinstance(sched, AcceleratedScheduler) and sched.optimizer is opt
    assert callable(other) and not isinstance(other, AcceleratedScheduler)
    assert acc._dataloaders == [dl] and acc._schedulers == [sched]
    assert dl.gradient_state is acc.gradient_state


class TokenRows(tud.Dataset):
    tokens = np.random.default_rng(4).integers(0, 256, (64, 32))

    def __len__(self):
        return len(self.tokens)

    def __getitem__(self, i):
        t = torch.from_numpy(self.tokens[i])
        return {"input_ids": t, "labels": t}


# -- a loader-fed trajectory against JAX --------------------------------------


def _jax_loader_trajectory(recipe, accum, mode, loader):
    JaxAcceleratorState._reset_state(reset_partial_state=True)
    JaxGradientState._reset_state()
    cfg = jl.LlamaConfig.tiny(dtype=jnp.float32, num_hidden_layers=2)
    model = jl.LlamaForCausalLM(cfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    host = jax.tree.map(lambda x: np.array(x, copy=True), params)
    acc = JaxAccelerator(
        mixed_precision="no",
        gradient_accumulation_plugin=jdc.GradientAccumulationPlugin(num_steps=accum, mode=mode),
        dataloader_config=jdc.DataLoaderConfiguration(use_seedable_sampler=True, data_seed=3))
    dl = acc.prepare(loader)
    state = acc.create_train_state(params, jax_make_optimizer(recipe), apply_fn=model.apply)
    step = acc.prepare_train_step(jl.make_llama_loss_fn(model, fused_vocab_chunks=4))
    out = []
    for batch in dl:
        state, m = step(state, {"input_ids": batch["input_ids"], "labels": batch["labels"]})
        out.append((float(m["loss"]), float(m["grad_norm"])))
    JaxGradientState._reset_state()
    return host, np.asarray(out)


@pytest.mark.parametrize("recipe, accum, mode", [("lion-sr", 1, "in_step"),
                                                 ("adamw", 2, "across_steps")])
def test_loader_fed_trajectory_matches_jax(recipe, accum, mode):
    def loader():
        return torch.utils.data.DataLoader(TokenRows(), batch_size=16,
                                           shuffle=True)

    host, want = _jax_loader_trajectory(recipe, accum, mode, loader())
    model = LlamaForCausalLM(LlamaConfig.tiny(dtype=torch.float32), device="cpu")
    model.load_state_dict(torch_state_from_flax(host))
    acc = Accelerator(cpu=True, gradient_accumulation_plugin=GradientAccumulationPlugin(
        num_steps=accum, mode=mode), dataloader_config=DataLoaderConfiguration(
        use_seedable_sampler=True, data_seed=3))
    dl = acc.prepare(loader())
    state = acc.create_train_state(model, recipe)
    step = acc.prepare_train_step(make_llama_loss_fn(model, fused_vocab_chunks=4))
    got = []
    for batch in dl:
        state, m = step(state, batch)
        got.append((m["loss"].item(), m["grad_norm"].item()))
    got = np.asarray(got)
    assert len(got) == len(want) == 4
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=1e-3)
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=5e-3)
    if mode == "across_steps":
        assert state.step == 2 and state.accum_step == 0 and acc.step_count == 4
