"""Dataset/dataloader registry (counterpart of lidiff_tpu/data/datasets.py;
the refine data module comes with the refiner).

`dataloaders['KITTI'](cfg)` returns a module exposing
train/val/test_dataloader() — same surface as the reference Lightning data
modules, backed by the threaded loader.
"""

from __future__ import annotations

from lidiff_tpu_torch.data.kitti import TemporalKITTIDataset
from lidiff_tpu_torch.data.loader import DataLoader


class TemporalKittiDataModule:
    """Diffusion data (reference datasets.py:13-71): train on cfg seqs,
    val/test on the validation split (seq 08), val batch size 1."""

    def __init__(self, cfg):
        self.cfg = cfg

    def _make(self, seqs, split):
        d = self.cfg["data"]
        return TemporalKITTIDataset(
            data_dir=d["data_dir"], seqs=seqs, split=split,
            resolution=d["resolution"], num_points=d["num_points"],
            max_range=d["max_range"],
            dataset_norm=d.get("dataset_norm", False),
            std_axis_norm=d.get("std_axis_norm", False))

    def train_dataloader(self):
        ds = self._make(self.cfg["data"]["train"], self.cfg["data"]["split"])
        return DataLoader(ds, self.cfg["train"]["batch_size"], shuffle=True,
                          num_workers=self.cfg["train"]["num_workers"])

    def val_dataloader(self):
        ds = self._make(self.cfg["data"]["validation"], "validation")
        return DataLoader(ds, 1, num_workers=self.cfg["train"]["num_workers"])

    def test_dataloader(self):
        ds = self._make(self.cfg["data"]["validation"], "validation")
        return DataLoader(ds, self.cfg["train"]["batch_size"],
                          num_workers=self.cfg["train"]["num_workers"])


dataloaders = {"KITTI": TemporalKittiDataModule}
