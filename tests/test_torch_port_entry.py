"""The port's entry points after training against the JAX package's, on the
CPU (``V1T_PLATFORM=cpu``): ``submission``, ``ensemble`` (with
``models/ensemble.py`` and ``Trainer(regularizer_fn=...)``), ``demo`` (with
``analysis/attention_rollout.py``), ``misc.extract_attention_maps``,
``import_checkpoint`` and ``export_checkpoint``.

A JAX run directory is made without training: a small model's JAX weights
(2 blocks, emb 32, 2 heads, MLP 64, fp32, patch 8 stride 4: 121 tokens;
noise from a second seed on every weight, as ``test_torch_port_composed.py``
does, so that the readout does not average its channels) written with the
JAX package's ``save_args`` and checkpoint, on a synthetic Sensorium-layout
dataset with the mice S0 and S1 (behavior mode 0: S0 has no behavior). The
repository's ``export_checkpoint.py`` turns it into the reference layout,
which the port restores as it is: the chain by which a model trained on a
TPU reaches the card.

Tolerances: float32 predictions and ensemble outputs max|d| <= 2e-5 *
max|ref| (summation order over 2 blocks, as the port's other float32
model tests); the ensemble head after one epoch of ``fit_ensemble`` leaf
for leaf within 1e-5 * max|ref| + 1e-6 (``test_torch_port_loop.py``'s
bounds); the rollout heatmaps, min-max normalised to [0, 1], within 1e-4;
the un-standardised images, behaviors and pupil centers within 1e-5
relative. Ids, columns and key sets exactly; the port's predictions from
the exported directory and from its import bit for bit (the same weights).
"""

import csv
import dataclasses
import glob
import os
import pickle
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import demo as jax_demo_cli  # noqa: E402
import ensemble as jax_ensemble_cli  # noqa: E402
import export_checkpoint as jax_export_cli  # noqa: E402
import import_checkpoint as jax_import_cli  # noqa: E402
import submission as jax_submission_cli  # noqa: E402
from misc import extract_attention_maps as jax_extract_cli  # noqa: E402
from v1t_tpu import training as jax_training  # noqa: E402
from v1t_tpu.configs import Config as JaxConfig  # noqa: E402
from v1t_tpu.configs import save_args as jax_save_args  # noqa: E402
from v1t_tpu.data import loaders as jax_loaders  # noqa: E402
from v1t_tpu.models import build_model as jax_build_model  # noqa: E402
from v1t_tpu.models import ensemble as jax_ensemble  # noqa: E402
from v1t_tpu.models.model import init_model  # noqa: E402
from v1t_tpu.utils.scheduler import Scheduler as JaxScheduler  # noqa: E402
from v1t_tpu.utils.scheduler import save_checkpoint_file as jax_save_ckpt  # noqa: E402

from v1t_tpu_torch import demo, ensemble, export_checkpoint, import_checkpoint  # noqa: E402
from v1t_tpu_torch import submission, training  # noqa: E402
from v1t_tpu_torch.configs import Config  # noqa: E402
from v1t_tpu_torch.data import loaders, synthetic  # noqa: E402
from v1t_tpu_torch.misc import extract_attention_maps  # noqa: E402
from v1t_tpu_torch.models import build_model  # noqa: E402
from v1t_tpu_torch.models import ensemble as port_ensemble  # noqa: E402
from v1t_tpu_torch.utils.scheduler import Scheduler, load_checkpoint_file  # noqa: E402

torch.set_num_threads(2)

MICE = ["S0", "S1"]
RUN = dict(core="vit", readout="gaussian2d", behavior_mode=0, shift_mode=2, num_blocks=2,
           emb_dim=32, num_heads=2, mlp_dim=64, patch_size=8, patch_stride=4, t_dropout=0.0,
           p_dropout=0.0, precision="fp32", batch_size=8, verbose=0, mouse_ids=MICE)
TOL = 2e-5


@pytest.fixture(autouse=True)
def on_the_cpu(monkeypatch):
    monkeypatch.setenv("V1T_PLATFORM", "cpu")


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    return synthetic.generate_dataset(
        str(tmp_path_factory.mktemp("data")), mouse_ids=MICE, num_neurons=24, num_train=16,
        num_validation=8, num_test_images=2, num_test_repeats=3, num_final_test=4)


def _jax_run(root, out, seed):
    """A JAX run directory (args.yaml, ckpt/model_state.msgpack) holding a
    small model's JAX weights; returns (directory, params)."""
    config = JaxConfig(**RUN, dataset=root, output_dir=str(out), seed=seed)
    config.ds_name = "sensorium"
    _, _, _, card = jax_loaders.get_training_ds(config, root, MICE, config.batch_size)
    params = init_model(jax_build_model(config, card), seed=seed)
    rng = np.random.default_rng(seed + 100)
    params = jax.tree.map(lambda p: np.asarray(p) + rng.normal(
        size=p.shape, scale=p.shape[0] ** -0.5 if p.ndim >= 2 else 0.1).astype(np.float32),
        params)
    jax_save_args(config)
    jax_save_ckpt(os.path.join(str(out), "ckpt", "model_state.msgpack"),
                  {"epoch": 1, "value": 0.25, "model": params})
    return str(out), params


def _export(monkeypatch, run_dir, torch_out):
    """The repository's export_checkpoint.py: JAX run -> reference layout."""
    monkeypatch.setattr(sys, "argv", ["export_checkpoint.py", "--output_dir", run_dir,
                                      "--torch_out", str(torch_out)])
    jax_export_cli.main()
    return str(torch_out)


@pytest.fixture(scope="module")
def runs(data_dir, tmp_path_factory):
    """Two JAX runs and their exports (seeds 1 and 2)."""
    mp = pytest.MonkeyPatch()
    try:
        out = {}
        for seed in (1, 2):
            base = tmp_path_factory.mktemp(f"run{seed}")
            run_dir, params = _jax_run(data_dir, base / "jax", seed)
            out[seed] = dict(jax=run_dir, params=params,
                             exported=_export(mp, run_dir, base / "exported"))
        return out
    finally:
        mp.undo()


def _latest(run_dir, pattern):
    stamps = sorted(glob.glob(os.path.join(run_dir, "submissions", "*")))
    assert stamps
    return os.path.join(stamps[-1], pattern)


def _read_csv(filename):
    with open(filename, newline="") as f:
        return list(csv.reader(f))


def _close(got, want, tol=TOL, atol=0.0, name=""):
    got = np.asarray(torch.as_tensor(got).detach().double().numpy())
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    err = np.abs(got - want).max() if got.size else 0.0
    assert err <= tol * np.abs(want).max() + atol, (name, err)


def _assert_csvs_match(got_dir, want_dir, bit_for_bit=False):
    checked = 0
    for challenge in ("sensorium", "sensorium+"):
        for name in ("live_test.csv", "final_test.csv"):
            got = _read_csv(os.path.join(got_dir, challenge, name))
            want = _read_csv(os.path.join(want_dir, challenge, name))
            assert got[0] == want[0] == ["trial_indices", "image_ids", "prediction",
                                         "neuron_ids"]
            assert len(got) == len(want) > 1
            for row, ref in zip(got[1:], want[1:]):
                assert (row[0], row[1], row[3]) == (ref[0], ref[1], ref[3])
                if bit_for_bit:
                    assert row[2] == ref[2]
                else:
                    _close(np.array(eval(row[2])), np.array(eval(ref[2])), name=name)
            checked += 1
    assert checked == 4


# --- submission -----------------------------------------------------------------------


def test_submission_main_matches_jax_through_export_and_import(runs, tmp_path):
    """JAX run -> the JAX submission; the same run exported by the
    repository's export_checkpoint.py -> the port's submission, restored as
    it is, and after ``import_checkpoint`` (bit for bit the same CSVs)."""
    run = runs[1]
    args = types.SimpleNamespace(output_dir=run["jax"], dataset=None, batch_size=4, verbose=0)
    jax_submission_cli.main(args)
    port_dir = submission.main(submission.parse_args(
        ["--output_dir", run["exported"], "--batch_size", "4", "--verbose", "0"]))
    _assert_csvs_match(port_dir, _latest(run["jax"], ""))
    summary = import_checkpoint.main(import_checkpoint.parse_args(
        ["--torch_dir", run["exported"], "--output_dir", str(tmp_path / "imported")]))
    assert summary["structurally_validated"] and summary["mouse_ids"] == MICE
    imported_dir = submission.main(submission.parse_args(
        ["--output_dir", str(tmp_path / "imported"), "--batch_size", "4", "--verbose", "0"]))
    _assert_csvs_match(imported_dir, port_dir, bit_for_bit=True)


def test_save_csv_writes_pandas_bytes(tmp_path):
    rng = np.random.default_rng(0)
    results = {"trial_ids": [3, 1, 2], "image_ids": [7, 7, 9],
               "predictions": rng.random((3, 4)).astype(np.float32).tolist(),
               "neuron_ids": [list(range(4))] * 3}
    submission.save_csv(str(tmp_path / "port" / "s.csv"), results)
    pd.DataFrame({"trial_indices": results["trial_ids"], "image_ids": results["image_ids"],
                  "prediction": results["predictions"], "neuron_ids": results["neuron_ids"]}
                 ).to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "port" / "s.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


# --- checkpoints -----------------------------------------------------------------------


def test_import_translates_args_as_jax(runs, tmp_path):
    payload = {"core": "vit", "readout": "gaussian2d", "behavior_mode": 3, "device": "cuda",
               "trainable_params": 123, "mouse_ids": ["A", "B"], "emb_dim": 48,
               "output_shapes": {"A": [7], "B": [9]}, "input_shape": [1, 36, 64],
               "not_a_field": 1, "precision": "bf16"}
    got = import_checkpoint.reference_args_to_config(payload, "out", overrides={
        "precision": "fp32"})
    want = jax_import_cli.reference_args_to_config(payload, "out", overrides={
        "precision": "fp32"})
    fields = {f.name for f in dataclasses.fields(Config)}
    assert {k: v for k, v in dataclasses.asdict(got).items()} == {
        k: v for k, v in dataclasses.asdict(want).items() if k in fields}
    state = load_checkpoint_file(os.path.join(runs[1]["exported"], "ckpt", "model_state.pt"))
    assert import_checkpoint._infer_mouse_ids(state["model"]) == jax_import_cli._infer_mouse_ids(
        state["model"]) == MICE
    # without args.yaml: the mice come from the keys, no input_shape to check against
    bare = tmp_path / "bare"
    os.makedirs(bare / "ckpt")
    torch.save({"model": state["model"]}, bare / "ckpt" / "model_state.pt")
    summary = import_checkpoint.convert_run(str(bare), str(tmp_path / "out"))
    assert summary["mouse_ids"] == MICE and not summary["structurally_validated"]
    # a key the port's model lacks fails the structure check
    broken = dict(state["model"], **{"core.extra": torch.zeros(1)})
    torch.save({"model": broken}, bare / "ckpt" / "model_state.pt")
    (bare / "args.yaml").write_text(open(os.path.join(runs[1]["exported"], "args.yaml")).read())
    with pytest.raises(RuntimeError, match="core.extra"):
        import_checkpoint.convert_run(str(bare), str(tmp_path / "out2"))


def test_export_then_import_round_trips(runs, tmp_path):
    """A port run -> the reference layout {epoch, value, model} -> a port
    run again: the same tensors bit for bit, the same args."""
    imported = tmp_path / "imported"
    import_checkpoint.convert_run(runs[2]["exported"], str(imported))
    path = export_checkpoint.main(["--output_dir", str(imported), "--torch_out",
                                   str(tmp_path / "ref")])
    payload = torch.load(path, weights_only=True)
    assert sorted(payload) == ["epoch", "model", "value"]
    again = tmp_path / "again"
    import_checkpoint.convert_run(str(tmp_path / "ref"), str(again))
    first = load_checkpoint_file(str(imported / "ckpt" / "model_state.pt"))
    second = load_checkpoint_file(str(again / "ckpt" / "model_state.pt"))
    assert first["model"].keys() == second["model"].keys()
    assert all(torch.equal(first["model"][k], second["model"][k]) for k in first["model"])
    assert (first["epoch"], first["value"]) == (second["epoch"], second["value"]) == (1, 0.25)


# --- ensemble --------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [0, 1, 2])
def test_output_module_matches_jax(mode):
    rng = np.random.default_rng(mode)
    inputs = rng.normal(size=(3, 24, 2)).astype(np.float32)
    jax_head = jax_ensemble.OutputModule(ensemble_mode=mode, in_features=2,
                                         mouse_ids=tuple(MICE))
    params = jax_head.init(jax.random.key(0), jnp.asarray(inputs), mouse_id="S1")
    params = jax.tree.map(lambda p: np.asarray(p) + rng.normal(size=p.shape).astype(np.float32),
                          params)
    head = port_ensemble.OutputModule(mode, 2, MICE)
    # JAX creates the layer of the mouse it was called with (mode 2: linear_S1)
    layers = {1: {"linear": getattr(head, "linear", None)},
              2: {f"linear_{m}": head.linear[m] for m in MICE} if mode == 2 else {}}.get(mode, {})
    with torch.no_grad():
        for name, layer in layers.items():
            if name in params["params"]:
                layer.weight.copy_(torch.from_numpy(params["params"][name]["kernel"].T))
                layer.bias.copy_(torch.from_numpy(params["params"][name]["bias"]))
    assert len(list(head.parameters())) == {0: 0, 1: 2, 2: 4}[mode]
    want = jax_head.apply(params, jnp.asarray(inputs), mouse_id="S1")
    _close(head(torch.from_numpy(inputs), "S1"), np.asarray(want), 1e-6)


def _ensemble_configs(root, out, **fields):
    fields = dict(dataset=root, output_dir=str(out), behavior_mode=0, batch_size=8,
                  micro_batch_size=8, precision="fp32", verbose=0, mouse_ids=MICE, seed=5,
                  **fields)
    jax_config, config = JaxConfig(**fields), Config(**fields)
    for c in (jax_config, config):
        c.ds_name = "sensorium"
    return jax_config, config


def test_fit_ensemble_one_epoch_matches_jax_head(runs, data_dir, tmp_path):
    """Mode 2 with the head trained one epoch (lr 1e-2, weight decay 0.01):
    the JAX package's ``fit_ensemble`` over the JAX runs, the port's over
    their exports from the same initial head; the sub-models stay frozen
    and the head matches leaf for leaf."""
    jax_config, config = _ensemble_configs(data_dir, tmp_path / "ens", ensemble_mode=2,
                                           train=True, epochs=1, lr=1e-2)
    jax_config.output_dir, config.output_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    jsets = jax_loaders.get_training_ds(jax_config, data_dir, MICE, 8)
    sets = loaders.get_training_ds(config, data_dir, MICE, 8)
    jmodel, jparams, jstate = jax_ensemble.build_ensemble(
        jax_config, {"m1": runs[1]["jax"], "m2": runs[2]["jax"]}, jsets[3])
    model = port_ensemble.build_ensemble(
        config, {"m1": runs[1]["exported"], "m2": runs[2]["exported"]}, sets[3], device="cpu")
    with torch.no_grad():  # the JAX head's initial draw
        for m in MICE:
            leaf = jparams["output_module"][f"linear_{m}"]
            model.output_module.linear[m].weight.copy_(torch.from_numpy(
                np.array(leaf["kernel"]).T))
            model.output_module.linear[m].bias.copy_(torch.from_numpy(np.array(leaf["bias"])))
    frozen = {k: v.clone() for k, v in model.ensemble.state_dict().items()}
    kw = dict(trainable_modules=["output_module"], weight_decay=0.01)
    jtrainer = jax_training.Trainer(jax_config, jmodel, jparams, jsets[3], model_state=jstate,
                                    regularizer_fn=jax_ensemble.ensemble_regularizer, **kw)
    trainer = training.Trainer(config, model, sets[3], device="cpu",
                               regularizer_fn=port_ensemble.ensemble_regularizer, **kw)
    assert [p for p in model.parameters() if p.requires_grad] == list(
        model.output_module.parameters())
    jax_ensemble_cli.fit_ensemble(jax_config, jtrainer,
                                  JaxScheduler(jax_config, mode="max",
                                               module_names=["output_module"]), *jsets[:3])
    ensemble.fit_ensemble(config, trainer, Scheduler(config, mode="max",
                                                     module_names=["output_module"]),
                          *sets[:3])
    for m in MICE:
        leaf = jtrainer.params["output_module"][f"linear_{m}"]
        layer = trainer.model.output_module.linear[m]
        _close(layer.weight, np.asarray(leaf["kernel"]).T, 1e-5, 1e-6, f"{m} weight")
        _close(layer.bias, np.asarray(leaf["bias"]), 1e-5, 1e-6, f"{m} bias")
    assert all(torch.equal(v, frozen[k]) for k, v in model.ensemble.state_dict().items())
    ckpt = load_checkpoint_file(str(tmp_path / "port" / "ckpt" / "model_state.pt"))
    assert sorted(ckpt["model"]) == sorted(f"output_module.linear.{m}.{p}" for m in MICE
                                           for p in ("bias", "weight"))


def test_ensemble_main_average_matches_jax(runs, data_dir, tmp_path):
    """Mode 0 end to end: validation, evaluation and the submission CSVs of
    the averaged runs, the JAX CLI's and the port's."""
    jax_config, config = _ensemble_configs(data_dir, tmp_path / "jax", ensemble_mode=0)
    config.output_dir = str(tmp_path / "port")
    jax_ensemble_cli.main(jax_config, saved_models={"m1": runs[1]["jax"], "m2": runs[2]["jax"]})
    port_dir = ensemble.main(config, {"m1": runs[1]["exported"], "m2": runs[2]["exported"]})
    _assert_csvs_match(port_dir, _latest(str(tmp_path / "jax"), ""))
    cfg, saved = ensemble.parse_args(
        ["--dataset", data_dir, "--output_dir", "o", "--behavior_mode", "0",
         "--saved_models", "a=runs/x", "runs/y", "--ensemble_mode", "2", "--train"])
    assert saved == {"a": "runs/x", "model1": "runs/y"}
    assert (cfg.ensemble_mode, cfg.train, cfg.weight_decay, cfg.lr) == (2, True, 0.01, 1e-3)


# --- demo and the attention rollout ------------------------------------------------------


def test_demo_main_matches_jax(runs, tmp_path):
    """The JAX demo on the JAX run, the port's on its export: the test
    evaluation and the rollout maps of the first validation mouse."""
    run = runs[2]
    jax_demo_cli.main(types.SimpleNamespace(output_dir=run["jax"], batch_size=4, num_maps=5))
    with open(os.path.join(run["jax"], "demo_attention_maps.pkl"), "rb") as f:
        want = pickle.load(f)
    got = demo.main(demo.parse_args(["--output_dir", run["exported"], "--batch_size", "4",
                                     "--num_maps", "5"]))["maps"]
    with open(os.path.join(run["exported"], "demo_attention_maps.pkl"), "rb") as f:
        saved = pickle.load(f)
    assert got.keys() == want.keys() == saved.keys() == {"images", "heatmaps",
                                                          "pupil_centers", "behaviors"}
    assert got["heatmaps"].shape == want["heatmaps"].shape == (5, 36, 64)
    for key in want:
        assert np.array_equal(saved[key], got[key])
        if key == "heatmaps":
            _close(got[key], want[key], 0.0, 1e-4, key)
        else:
            _close(got[key], want[key], 1e-5, 0.0, key)


def test_extract_attention_maps_main_matches_jax(runs):
    """``misc/extract_attention_maps.py`` on the JAX run, the port's
    ``python -m v1t_tpu_torch.misc.extract_attention_maps`` on its export:
    every mouse's validation and test trials, {tier: {mouse: {...}}}."""
    run = runs[1]
    args = dict(batch_size=4, num_samples=None, verbose=0)
    jax_extract_cli.main(types.SimpleNamespace(output_dir=run["jax"], **args))
    with open(os.path.join(run["jax"], "attention_maps.pkl"), "rb") as f:
        want = pickle.load(f)
    got = extract_attention_maps.main(extract_attention_maps.parse_args(
        ["--output_dir", run["exported"], "--batch_size", "4", "--verbose", "0"]))
    with open(os.path.join(run["exported"], "attention_maps.pkl"), "rb") as f:
        saved = pickle.load(f)
    assert got.keys() == want.keys() == saved.keys() == {"validation", "test"}
    for tier in want:
        assert got[tier].keys() == want[tier].keys() == set(MICE)
        for mouse in want[tier]:
            assert got[tier][mouse].keys() == want[tier][mouse].keys() == {
                "images", "heatmaps", "pupil_centers", "behaviors"}
            assert got[tier][mouse]["heatmaps"].shape == want[tier][mouse]["heatmaps"].shape
            for key, value in want[tier][mouse].items():
                assert np.array_equal(saved[tier][mouse][key], got[tier][mouse][key])
                if key == "heatmaps":
                    _close(got[tier][mouse][key], value, 0.0, 1e-4, key)
                else:
                    _close(got[tier][mouse][key], value, 1e-5, 0.0, key)


def test_entry_points_need_a_card_unless_asked_for_the_cpu(monkeypatch, runs, data_dir):
    monkeypatch.delenv("V1T_PLATFORM")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="V1T_PLATFORM=cpu"):
        submission.main(submission.parse_args(["--output_dir", runs[1]["exported"]]))
    with pytest.raises(RuntimeError, match="V1T_PLATFORM=cpu"):
        demo.main(demo.parse_args(["--output_dir", runs[1]["exported"]]))
    _, config = _ensemble_configs(data_dir, "unused", ensemble_mode=0)
    with pytest.raises(RuntimeError, match="V1T_PLATFORM=cpu"):
        ensemble.main(config, {"m1": runs[1]["exported"]})


def test_trainer_regularizer_fn_replaces_the_model_regularizer(runs, data_dir):
    config = Config(**RUN, dataset=data_dir, output_dir="unused")
    config.ds_name = "sensorium"
    train_ds, _, _, card = loaders.get_training_ds(config, data_dir, MICE, 8)
    model = build_model(config, card, seed=0, device="cpu")
    seen = []

    def reg(m, mouse_id):
        seen.append((m is model, mouse_id))
        return torch.tensor(2.5)

    trainer = training.Trainer(config, model, card, device="cpu", regularizer_fn=reg)
    _, metrics = trainer.train_step("S1", next(iter(train_ds["S1"])), None, update=True)
    assert seen == [(True, "S1")] and float(metrics["loss/reg_loss"]) == 2.5
