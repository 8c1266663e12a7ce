"""The port's LM training driver (``repro_torch.launch.train``), its data
(``data.token_stream``) and bf16 checkpoints, against the JAX reference.

  * ``token_stream`` bit-identical to the reference's, and ``make_lm_data``
    yielding the reference's batches;
  * ``train()`` on the granite-3-2b and zamba2-1.2b smoke configs in fp32
    from the reference's parameters (numpy), each step's loss and
    gradient norm within rtol 1e-5 of ``oracle_trajectory``
    (``tests/test_torch_lm_train.py``: the reference's train-step body) fed
    the same ``make_lm_data`` batches — the reference's own driver fails
    on jax 0.9 (ROADMAP.md, R2);
  * crash and resume: a 6-step run dies right after its checkpoint of
    step index 2 is written, and a second 6-step run in the same directory
    resumes at step 3 with the batcher restored from the checkpoint's
    ``data_state``: the losses of steps 3-5 equal an uninterrupted run's
    bit for bit, in bf16 and fp32.  The run that dies is given the same
    ``steps`` as the others because ``make_lm_data``, as the reference's,
    sizes the token stream by ``steps``: a run of 4 steps trains on another
    stream, which the CLI test shows resuming all the same;
  * a bfloat16 leaf saved and restored bit for bit, its ``.npy`` bytes
    equal to the reference ``Checkpointer``'s for the same leaf, and the
    port restoring the reference's checkpoint (the reference cannot read
    back its own bf16 leaves: ``jnp.asarray`` of the two-byte void array
    ``np.load`` returns raises, ROADMAP.md);
  * the encoder-decoder and VLM archs refused, and the CLI.
"""

import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.data.pipeline import token_stream as j_token_stream
from repro.launch.train import make_lm_data as j_make_lm_data
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import smoke_config
from repro_torch.data import token_stream
from repro_torch.launch import train as T
from repro_torch.launch.steps import TrainSettings
from test_torch_lm_train import models, oracle_trajectory

TRAJ_RTOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,vocab,seed,zipf_a", [
    (1, 7, 0, 1.2), (4097, 256, 0, 1.2), (10_000, 49155, 3, 1.2),
    (2048, 32000, 1, 1.5)])
def test_token_stream_bit_identical_to_reference(n, vocab, seed, zipf_a):
    got = token_stream(n, vocab, seed=seed, zipf_a=zipf_a)
    want = j_token_stream(n, vocab, seed=seed, zipf_a=zipf_a)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch,batch,seq,steps", [
    ("granite-3-2b", 4, 32, 5), ("zamba2-1.2b", 2, 16, 7)])
def test_make_lm_data_matches_reference(arch, batch, seq, steps):
    cfg = smoke_config(arch)
    n = batch * seq * (steps + 4)
    ours = T.make_lm_data(cfg, n, batch, seq, "cpu")
    theirs = j_make_lm_data(cfg, n, batch, seq, None)
    for _ in range(2 * (steps + 4)):          # past the wrap of the rows
        a, b = next(ours), next(theirs)
        assert set(a) == set(b) == {"tokens", "labels"}
        for key in a:
            np.testing.assert_array_equal(a[key].numpy(), np.asarray(b[key]))
    assert ours.state() == theirs.state()


@pytest.mark.parametrize("arch,microbatches", [("granite-3-2b", 1),
                                               ("zamba2-1.2b", 2)])
def test_train_matches_oracle_trajectory(arch, microbatches, tmp_path):
    """fp32, (4, 32) batches, 5 steps at lr 1e-3, no checkpoint."""
    batch, seq, steps, lr = 4, 32, 5, 1e-3
    cfg, _, jm, _, jp, _ = models(arch)
    run = T.train(arch, cfg=cfg, steps=steps, batch=batch, seq=seq, lr=lr,
                  microbatches=microbatches, device="cpu",
                  checkpoint_dir=str(tmp_path), checkpoint_every=0,
                  params=jax.tree.map(np.asarray, jp))
    data = T.make_lm_data(cfg, batch * seq * (steps + 4), batch, seq, "cpu")
    jbs = [{k: jnp.asarray(v.numpy()) for k, v in next(data).items()}
           for _ in range(steps)]
    want = oracle_trajectory(
        jm, jp, jbs, TrainSettings(learning_rate=lr,
                                   microbatches=microbatches), steps)
    got = [(h["loss"], h["grad_norm"]) for h in run.history]
    print(f"{arch}: port {got}\n  reference {want}")
    assert [h["step"] for h in run.history] == list(range(steps))
    assert all(isinstance(h["loss"], float) for h in run.history)
    np.testing.assert_allclose(np.array(got), np.array(want), rtol=TRAJ_RTOL)
    assert got[-1][0] < got[0][0]
    assert run.resumed_from is None and run.cfg is cfg
    assert not os.listdir(tmp_path)


class Crash(Exception):
    pass


class CrashAfterSave(Checkpointer):
    """Writes its first checkpoint in full, then dies as the process would."""

    def save(self, step, state, blocking=True, extra_meta=None):
        super().save(step, state, blocking=True, extra_meta=extra_meta)
        raise Crash(step)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_crash_and_resume_equals_uninterrupted_run(dtype, tmp_path):
    cfg = smoke_config("granite-3-2b").replace(dtype=dtype,
                                               param_dtype=dtype)
    kw = dict(cfg=cfg, steps=6, batch=4, seq=32, lr=1e-3, device="cpu")
    ck_dir = str(tmp_path / "ck")
    with pytest.raises(Crash):
        T.train("granite-3-2b", checkpoint_every=3, checkpoint_dir=ck_dir,
                checkpointer=CrashAfterSave(ck_dir), **kw)
    assert sorted(os.listdir(ck_dir)) == ["step_2"]
    ck = Checkpointer(ck_dir)
    assert ck.meta(2)["data_state"] == {"step": 3}   # batches 0-2 drawn
    resumed = T.train("granite-3-2b", checkpoint_every=3,
                      checkpoint_dir=ck_dir, **kw)
    whole = T.train("granite-3-2b", checkpoint_every=0,
                    checkpoint_dir=str(tmp_path / "fresh"), **kw)
    assert resumed.resumed_from == 2 and whole.resumed_from is None
    assert [h["step"] for h in resumed.history] == [3, 4, 5]
    assert sorted(os.listdir(ck_dir)) == ["step_2", "step_5"]
    emb = torch.zeros(cfg.vocab_size, cfg.d_model, dtype=getattr(torch, dtype))
    state = ck.restore(5, {"params": {"embedding": {"w": emb}}})
    assert state["params"]["embedding"]["w"].dtype == getattr(torch, dtype)
    assert [(h["loss"], h["grad_norm"]) for h in resumed.history] == [
        (h["loss"], h["grad_norm"]) for h in whole.history[3:]]
    assert whole.history[-1]["loss"] < whole.history[0]["loss"]


def _bf16_leaf(shape, seed=0):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2**16, size=shape, dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] &= 0xBFFF       # no inf or nan patterns
    return bits


@pytest.mark.parametrize("shape", [(3, 5), (), (0, 4), (2, 3, 4)])
def test_bf16_leaf_checkpoint_bytes_match_reference(shape, tmp_path):
    bits = _bf16_leaf(shape)
    leaf = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    jleaf = jnp.asarray(bits.view(ml_dtypes.bfloat16))
    Checkpointer(str(tmp_path / "port")).save(0, {"p": {"w": leaf}})
    JCheckpointer(str(tmp_path / "ref")).save(0, {"p": {"w": jleaf}})
    name = os.path.join("step_0", "p__w.npy")
    ours = (tmp_path / "port" / name).read_bytes()
    theirs = (tmp_path / "ref" / name).read_bytes()
    assert b"'descr': '<V2'" in ours
    assert ours == theirs
    like = {"p": {"w": torch.zeros(shape, dtype=torch.bfloat16)}}
    for src in ("port", "ref"):
        back = Checkpointer(str(tmp_path / src)).restore(0, like)["p"]["w"]
        assert back.dtype == torch.bfloat16 and back.shape == leaf.shape
        assert torch.equal(back.view(torch.int16), leaf.view(torch.int16))


def test_bf16_leaf_restores_into_fp32(tmp_path):
    bits = _bf16_leaf((4, 6), seed=1)
    leaf = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    ck = Checkpointer(str(tmp_path))
    ck.save(1, {"w": leaf, "m": torch.arange(6.0)})
    back = ck.restore(1, {"w": torch.zeros(4, 6), "m": torch.zeros(6)})
    assert back["w"].dtype == torch.float32
    assert torch.equal(back["w"], leaf.float())
    assert torch.equal(back["m"], torch.arange(6.0))


@pytest.mark.parametrize("arch", ["seamless-m4t-large-v2", "qwen2-vl-72b"])
def test_encdec_and_vlm_are_refused(arch, tmp_path):
    with pytest.raises(ValueError, match="token-LM archs"):
        T.train(arch, smoke=True, steps=1, device="cpu",
                checkpoint_dir=str(tmp_path))
    with pytest.raises(SystemExit, match="token-LM archs"):
        T.main(["--arch", arch, "--smoke", "--device", "cpu",
                "--checkpoint-dir", str(tmp_path)])


def test_cli_trains_and_resumes(tmp_path, capsys):
    args = ["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
            "--batch", "4", "--seq", "32", "--lr", "1e-3",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "3"]
    assert T.main([*args, "--steps", "4"]) == 0
    out = capsys.readouterr().out
    assert "granite-3-2b-smoke: 4 steps in" in out
    assert "stragglers observed: 0" in out
    assert T.main([*args, "--steps", "6"]) == 0
    assert "granite-3-2b-smoke: 3 steps in" in capsys.readouterr().out
    assert T.main([*args, "--steps", "5"]) == 0
    assert "nothing to do" in capsys.readouterr().out


def test_cli_fails_when_the_loss_does_not_fall(tmp_path):
    with pytest.raises(SystemExit, match="loss did not decrease"):
        T.main(["--arch", "granite-3-2b", "--smoke", "--device", "cpu",
                "--steps", "3", "--lr=-1e-2", "--checkpoint-dir",
                str(tmp_path), "--checkpoint-every", "0"])
