"""The port's training entry point, ``python -m v1t_tpu_torch.train``,
against the repository's ``train.py``, on the CPU.

The two parsers build equal ``Config``s from the same argv; an
``args.yaml`` written by either package is read by the other into an equal
``Config``, and the port's own YAML emitter (used where PyYAML is missing)
writes ``yaml.safe_dump``'s bytes; ``main`` runs a tiny model for 2 epochs
under ``V1T_PLATFORM=cpu`` and writes the run directory, and a second call
resumes from its checkpoint; without ``V1T_PLATFORM=cpu`` and without a
card it raises, and the flags whose paths are not ported raise and name
their ``ROADMAP.md`` item.
"""

import dataclasses
import os
import sys

import pytest
import torch
import yaml

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import train as jax_train  # noqa: E402
from v1t_tpu.configs import load_args as jax_load_args  # noqa: E402
from v1t_tpu.configs import save_args as jax_save_args  # noqa: E402

from v1t_tpu_torch import configs  # noqa: E402
from v1t_tpu_torch import train  # noqa: E402
from v1t_tpu_torch.data import synthetic  # noqa: E402
from v1t_tpu_torch.utils import yamlfile  # noqa: E402
from v1t_tpu_torch.utils.scheduler import load_checkpoint_file  # noqa: E402

BASE = ["--dataset", "data/sensorium", "--output_dir", "runs/x", "--behavior_mode", "3",
        "--core", "vit", "--readout", "gaussian2d"]
ARGVS = {
    "defaults": BASE,
    "flagship": BASE + ["--batch_size", "64", "--epochs", "3", "--precision", "bf16",
                        "--image_wire_dtype", "auto", "--mouse_ids", "A", "B", "--seed", "7"],
    "options": BASE + ["--use_lsa", "--disable_bias", "--amp", "--lr", "1e-05", "--core_lr",
                       "3e-4", "--shift_mode", "4", "--limit_data", "100", "--gray_scale",
                       "--attention_impl", "xla", "--readout_impl", "pallas",
                       "--micro_batch_size", "16", "--grid_predictor_dim", "3",
                       "--clear_output_dir", "--save_plots", "--format", "png"],
    "stacked2d": ["--dataset", "d/franke2022", "--output_dir", "o", "--behavior_mode", "0",
                  "--core", "stacked2d", "--readout", "gaussian2d", "--shift_mode", "0",
                  "--stacked2d_conv_type", "conv", "--linear"],
}


def _jax_config(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["train.py"] + argv)
    return jax_train.parse_config()


def _fields(config) -> dict:
    names = {f.name for f in dataclasses.fields(configs.Config)}
    return {k: v for k, v in dataclasses.asdict(config).items() if k in names}


@pytest.mark.parametrize("case", sorted(ARGVS))
def test_parsers_build_equal_configs(monkeypatch, case):
    want = _jax_config(monkeypatch, ARGVS[case])
    monkeypatch.setattr(sys, "argv", ["x"])  # the port reads only its argv argument
    got = train.parse_config(ARGVS[case])
    assert {f.name for f in dataclasses.fields(got)} == {f.name for f in dataclasses.fields(want)}
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _hide_yaml(monkeypatch):
    monkeypatch.setitem(sys.modules, "yaml", None)  # import yaml raises ImportError


@pytest.mark.parametrize("hidden", [False, True], ids=["pyyaml", "own_emitter"])
def test_args_yaml_is_read_across_packages(monkeypatch, tmp_path, hidden):
    argv = ARGVS["options"] + ["--mouse_ids", "A", "N", "O"]
    config = train.parse_config(argv).replace(output_dir=str(tmp_path / "port"),
                                              input_shape=(1, 144, 256),
                                              output_shapes={"A": (7000,), "N": (12,)})
    payload = configs._yamlify(config.to_dict())
    assert yamlfile.dumps(payload, sort_keys=False) == yaml.safe_dump(payload, sort_keys=False)
    if hidden:
        _hide_yaml(monkeypatch)
    configs.save_args(config)
    monkeypatch.undo()
    want = jax_load_args(str(tmp_path / "port"))
    assert _fields(want) == _fields(config)
    # the other way round: the JAX package's args.yaml (with its git hash,
    # hostname and kernel knobs) read by the port
    jax_config = _jax_config(monkeypatch, argv)
    jax_config.output_dir = str(tmp_path / "jax")
    jax_config.output_shapes = {"A": (7000,), "N": (12,)}
    jax_save_args(jax_config)
    if hidden:
        _hide_yaml(monkeypatch)
    got = configs.load_args(str(tmp_path / "jax"))
    assert _fields(got) == _fields(jax_config)
    assert got.output_shapes == {"A": (7000,), "N": (12,)}


def test_own_emitter_writes_evaluation_yaml_bytes(tmp_path):
    results = {"single_trial_correlation": {"A": 0.1234, "B": -0.5, "average": 1e-07},
               "correlation_to_average": {}, "feve": {"A": float("nan"), "average": 2.0}}
    text = yamlfile.dumps(results)
    assert text == yaml.safe_dump(results)
    back = yamlfile.loads(text)
    assert back["single_trial_correlation"] == results["single_trial_correlation"]
    assert back["correlation_to_average"] == {} and back["feve"]["average"] == 2.0


class Recorder:
    """The hooks ``main`` calls, recording the run's progress."""

    def __init__(self):
        self.start, self.epochs, self.best = None, [], None

    def run_start(self, trainer, scheduler, epoch, loaders):
        self.start = epoch
        self.scheduler_state = scheduler.state_dict()
        self.loaders = loaders

    def epoch_end(self, epoch, train_result, val_result, trainer, scheduler):
        self.epochs.append((epoch, train_result["loss"], val_result["single_trial_correlation"]))

    def run_end(self, trainer, scheduler, eval_result):
        self.best = scheduler.best_epoch


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    return synthetic.generate_dataset(
        str(tmp_path_factory.mktemp("data")), mouse_ids=("A", "B"), num_neurons=16, num_train=24,
        num_validation=8, num_test_images=2, num_test_repeats=3)


def _tiny_argv(dataset, out, epochs):
    return ["--dataset", dataset, "--output_dir", str(out), "--behavior_mode", "3", "--core",
            "vit", "--readout", "gaussian2d", "--mouse_ids", "A", "B", "--batch_size", "8",
            "--epochs", str(epochs), "--num_blocks", "1", "--emb_dim", "16", "--num_heads", "2",
            "--mlp_dim", "32", "--patch_stride", "4", "--t_dropout", "0.1", "--verbose", "0",
            "--data_parallel", "1"]


def test_main_trains_on_the_cpu_and_resumes(monkeypatch, tmp_path, dataset):
    monkeypatch.setenv("V1T_PLATFORM", "cpu")
    out = tmp_path / "run"
    first = Recorder()
    result = train.main(train.parse_config(_tiny_argv(dataset, out, 2)), hooks=first)
    assert set(result) == {"single_trial_correlation", "correlation_to_average", "feve"}
    for name in ("args.yaml", "evaluation.yaml", "model.txt", "model_core.txt",
                 "model_readout.txt", "output.log", os.path.join("ckpt", "model_state.pt")):
        assert os.path.isfile(out / name), name
    assert first.start == 0 and [e[0] for e in first.epochs] == [1, 2]
    assert "trainable parameters" in (out / "model.txt").read_text()
    evaluation = yaml.safe_load((out / "evaluation.yaml").read_text())
    assert set(evaluation["single_trial_correlation"]) == {"A", "B", "average"}
    replay = configs.load_args(str(out))
    assert replay.output_shapes == {"A": (16,), "B": (16,)} and replay.input_shape == (1, 36, 64)
    assert replay.trainable_params > 0
    # every train batch came through the native assembler, on the bf16 wire
    train_loaders = first.loaders["train"]
    assert all(loader.image_dtype == "bfloat16" for loader in train_loaders.values())
    assert all(loader.dataset.native_batches == 2 * len(loader)
               for loader in train_loaders.values())

    ckpt = load_checkpoint_file(str(out / "ckpt" / "model_state.pt"))
    second = Recorder()
    config = configs.load_args(str(out), overrides={"epochs": 4, "verbose": 0})
    train.main(config, hooks=second)
    # the resume starts after the best checkpoint's epoch, its counters loaded
    assert second.start == ckpt["epoch"] == first.best
    assert second.scheduler_state == ckpt["scheduler"]
    assert [e[0] for e in second.epochs] == list(range(ckpt["epoch"] + 1, 5))


def test_main_needs_a_card_unless_asked_for_the_cpu(monkeypatch, tmp_path, dataset):
    monkeypatch.delenv("V1T_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="V1T_PLATFORM=cpu"):
        train.main(train.parse_config(_tiny_argv(dataset, tmp_path / "x", 1)))


@pytest.mark.parametrize("flags,item", [
    (["--pretrain_core", "some/run"], "item 8"),
    (["--data_parallel", "2"], "item 7"),
    (["--sequence_parallel", "2"], "item 7"),
    (["--use_lsa"], None),
    (["--drop_path", "0.1"], None),
    (["--patch_mode", "2"], None),
    (["--grad_checkpointing", "1"], None),
])
def test_unported_flags_raise_and_name_their_item(monkeypatch, tmp_path, dataset, flags, item):
    monkeypatch.setenv("V1T_PLATFORM", "cpu")
    config = train.parse_config(_tiny_argv(dataset, tmp_path / "x", 1) + flags)
    if item is None:  # a ported option passes the check, and its model builds
        train.check_ported(config, "cpu")
        from v1t_tpu_torch.data.cards import synthetic_data_card
        from v1t_tpu_torch.models import build_model

        build_model(config, synthetic_data_card(mouse_ids=("A",)), seed=0, device="cpu")
        return
    with pytest.raises(NotImplementedError, match=item):
        train.main(config)


@pytest.mark.parametrize("core,readout", [("stacked2d", "gaussian2d"), ("vit", "linear")])
def test_unported_cores_and_readouts_raise(monkeypatch, tmp_path, dataset, core, readout):
    monkeypatch.setenv("V1T_PLATFORM", "cpu")
    argv = ["--dataset", dataset, "--output_dir", str(tmp_path / "x"), "--behavior_mode", "3",
            "--core", core, "--readout", readout, "--data_parallel", "1"]
    with pytest.raises(NotImplementedError, match="item 6"):
        train.main(train.parse_config(argv))
