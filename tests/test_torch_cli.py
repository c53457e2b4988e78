"""The port's entry points on the CPU: ``python -m dsdiff_torch.cli.train``
on a YAML config with ``--device cpu`` trains (with validation image dumps),
saves, and on a second call resumes from the latest checkpoint; then
``python -m dsdiff_torch.cli.sample`` restores it, predicts the test split
to NIfTI volumes and scores them into ``metrics.csv``. The latent
workflow: ``python -m dsdiff_torch.cli.train_vae`` trains a KL-VAE, and a
``net_mode: latent`` run through the same two entry points diffuses in its
latent space with that checkpoint as ``vae_checkpoint``."""
import numpy as np
import pytest

from dsdiff_torch.cli import sample as sample_cli
from dsdiff_torch.cli import train as train_cli
from dsdiff_torch.cli import train_vae as train_vae_cli
from dsdiff_torch.data import h5store, synthetic
from dsdiff_torch.data.nifti import Nifti, write_nifti
from torch_parity_utils import one_thread, tiny_cfg

pytestmark = pytest.mark.usefixtures("one_thread")


@pytest.fixture()
def store(tmp_path):
    """An H5 store of 5 cases of 2 slices at 16², and the test case's
    ground truth as NIfTI."""
    synthetic.make_structured_dataset(tmp_path / "data", n_cases=5,
                                      n_slices=2, hw=16, seed=0)
    split = tmp_path / "data" / "images_ts_16"
    for case in h5store.list_cases(split):
        vol = np.stack([h5store.read_slice(p, ["GT"])["GT"]
                        for p in h5store.case_slices(split / case)], -1)
        (tmp_path / "gt" / case).mkdir(parents=True)
        write_nifti(tmp_path / "gt" / case / "GT.nii.gz", Nifti(vol))
    return tmp_path


def test_the_entry_points_train_resume_and_sample(store, tmp_path):
    import yaml

    cfg = tiny_cfg()
    cfg.update(h5_2d_img_dir=str(store / "data"), image_size=16,
               train_keys=["A", "B", "C", "GT"], train_batch_size=2,
               val_batch_size=2, fold_K=2, fold_idx=0, limit_val_batches=1,
               result_path=str(tmp_path / "results"), log_images=True,
               filepath_img=str(store / "gt"), Task_name="synth")
    path = tmp_path / "run.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert train_cli.main(["--config_file", str(path), "--max_steps", "2",
                           "--device", "cpu"]) == 2
    workdir = tmp_path / "results" / "synth_r1_ds_diff_gaussian_fold2-0"
    assert sorted(p.name for p in (workdir / "checkpoint").iterdir()) == ["2"]
    assert sorted(p.name for p in (workdir / "images" / "step_0000002")
                  .iterdir()) == [
        "denoise_row.png", "heatmap_c_s.png", "heatmap_c_s_perfect.png",
        "heatmap_s_a_l.png", "heatmap_s_a_l_perfect.png", "samples.png"]
    assert train_cli.main(["--config_file", str(path), "--num_epochs", "2",
                           "--device", "cpu"]) == 4
    assert "resumed from step 2" in (workdir / "log_txt.txt").read_text()
    out_dir, rows = sample_cli.main(["--config_file", str(path), "--workdir",
                                     str(workdir), "--device", "cpu",
                                     "--sample_steps", "2"])
    assert out_dir == workdir / "predictions" and len(rows) == 1
    assert (out_dir / "metrics.csv").exists()
    assert all(np.isfinite(v) for k, v in rows[0].items() if k != "case")
    with pytest.raises(SystemExit):
        train_cli.main([])  # --config_file is required


def test_the_entry_points_train_and_sample_a_ddpm_run(store, tmp_path):
    """A non-DS net_mode through the same entry points: ``ddpm`` (the plain
    conditional UNet, eps and L2 as configs/ddpm.yaml sets them)."""
    import yaml

    cfg = tiny_cfg()
    cfg.update(net_mode="ddpm", parameterization="eps", loss_type="l2",
               learn_sigma=False, disentangle_distance=None,
               unet_config={"params": dict(
                   model_channels=32, num_res_blocks=1,
                   attention_resolutions=[2], channel_mult=[1, 2],
                   num_head_channels=16, use_scale_shift_norm=True)},
               h5_2d_img_dir=str(store / "data"), image_size=16,
               train_keys=["A", "B", "C", "GT"], train_batch_size=2,
               val_batch_size=2, fold_K=2, fold_idx=0, limit_val_batches=1,
               result_path=str(tmp_path / "results"), log_images=False,
               filepath_img=str(store / "gt"), Task_name="synth")
    path = tmp_path / "ddpm.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert train_cli.main(["--config_file", str(path), "--max_steps", "1",
                           "--device", "cpu"]) == 1
    workdir = tmp_path / "results" / "synth_r1_ddpm_fold2-0"
    assert "model unet:" in (workdir / "log_txt.txt").read_text()
    assert sorted(p.name for p in (workdir / "checkpoint").iterdir()) == ["1"]
    out_dir, rows = sample_cli.main(["--config_file", str(path), "--workdir",
                                     str(workdir), "--device", "cpu",
                                     "--sample_steps", "2"])
    assert len(rows) == 1 and (out_dir / "metrics.csv").exists()
    assert all(np.isfinite(v) for k, v in rows[0].items() if k != "case")


def test_train_vae_then_a_latent_run_through_the_entry_points(store,
                                                              tmp_path):
    import yaml

    vae = {"params": {"ch": 8, "ch_mult": [1, 2], "num_res_blocks": 1,
                      "z_channels": 4, "embed_dim": 4}}
    vcfg = dict(Task_name="vae_synth", Task_id="r1",
                train_keys=["A", "B", "C", "GT"],
                h5_2d_img_dir=str(store / "data"), image_size=16,
                train_batch_size=2, num_epochs=1, lr=1e-4, seed=0, bf16=False,
                disc_start=0, disc_channels=8, disc_num_layers=2,
                result_path=str(tmp_path / "results"), first_stage=vae)
    vpath = tmp_path / "vae.yaml"
    vpath.write_text(yaml.safe_dump(vcfg))
    assert train_vae_cli.main(["--config_file", str(vpath), "--max_steps",
                               "2", "--device", "cpu"]) == 2
    vae_dir = tmp_path / "results" / "vae_synth_r1_vae"
    assert sorted(p.name for p in (vae_dir / "checkpoint").iterdir()) == ["2"]
    assert "VAE" in (vae_dir / "log_txt.txt").read_text()

    cfg = tiny_cfg()
    cfg.update(net_mode="latent", parameterization="v", loss_type="l2",
               learn_sigma=False, disentangle_distance=None,
               first_stage=vae, vae_checkpoint=str(vae_dir / "checkpoint"),
               unet_config={"params": dict(
                   model_channels=32, num_res_blocks=1,
                   attention_resolutions=[2], channel_mult=[1, 2],
                   num_head_channels=16, use_scale_shift_norm=True)},
               h5_2d_img_dir=str(store / "data"), image_size=16,
               train_keys=["A", "B", "C", "GT"], train_batch_size=2,
               val_batch_size=2, fold_K=2, fold_idx=0, limit_val_batches=1,
               result_path=str(tmp_path / "results"), log_images=False,
               filepath_img=str(store / "gt"), Task_name="synth")
    path = tmp_path / "latent.yaml"
    path.write_text(yaml.safe_dump(cfg))
    assert train_cli.main(["--config_file", str(path), "--max_steps", "1",
                           "--device", "cpu"]) == 1
    workdir = tmp_path / "results" / "synth_r1_latent_fold2-0"
    assert "vae restored from" in (workdir / "log_txt.txt").read_text()
    out_dir, rows = sample_cli.main(["--config_file", str(path), "--workdir",
                                     str(workdir), "--device", "cpu",
                                     "--sample_steps", "2"])
    assert len(rows) == 1 and (out_dir / "metrics.csv").exists()
    assert all(np.isfinite(v) for k, v in rows[0].items() if k != "case")
    with pytest.raises(SystemExit):
        train_vae_cli.main([])  # --config_file is required
