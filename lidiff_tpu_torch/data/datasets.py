"""Dataset/dataloader registry (counterpart of lidiff_tpu/data/datasets.py).

`dataloaders['KITTI'](cfg)` returns a module exposing
train/val/test_dataloader() — same surface as the reference Lightning data
modules, backed by the threaded loader.
"""

from __future__ import annotations

from lidiff_tpu_torch.data.kitti import (TemporalKITTIAggrDataset,
                                         TemporalKITTIDataset)
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

    def train_dataloader(self, rank: int = 0, world: int = 1):
        """The training batches; with `world` > 1, rank `rank`'s rows of
        each."""
        ds = self._make(self.cfg["data"]["train"], self.cfg["data"]["split"])
        return DataLoader(ds, self.cfg["train"]["batch_size"], shuffle=True,
                          num_workers=self.cfg["train"]["num_workers"],
                          rank=rank, world=world)

    def val_dataloader(self):
        ds = self._make(self.cfg["data"]["validation"], "validation")
        return DataLoader(ds, 1, num_workers=self.cfg["train"]["num_workers"])

    def test_dataloader(self):
        ds = self._make(self.cfg["data"]["validation"], "validation")
        return DataLoader(ds, self.cfg["train"]["batch_size"],
                          num_workers=self.cfg["train"]["num_workers"])


class TemporalKittiRefineDataModule:
    """Refine data (reference datasets_refine.py): aggregated windows."""

    def __init__(self, cfg):
        self.cfg = cfg

    def _make(self, seqs, split):
        d = self.cfg["data"]
        return TemporalKITTIAggrDataset(
            data_dir=d["data_dir"], scan_window=d["scan_window"], seqs=seqs,
            split=split, resolution=d["resolution"],
            num_points=d["num_points"])

    def _loader(self, ds, batch_size, shuffle=False, rank=0, world=1):
        return DataLoader(ds, batch_size, shuffle=shuffle,
                          part_key="pcd_noise",
                          num_workers=self.cfg["train"]["num_workers"],
                          rank=rank, world=world)

    def train_dataloader(self, rank: int = 0, world: int = 1):
        """The training batches; with `world` > 1, rank `rank`'s rows of
        each."""
        ds = self._make(self.cfg["data"]["train"], self.cfg["data"]["split"])
        return self._loader(ds, self.cfg["train"]["batch_size"], shuffle=True,
                            rank=rank, world=world)

    def val_dataloader(self):
        return self._loader(
            self._make(self.cfg["data"]["validation"], "validation"), 1)

    def test_dataloader(self):
        return self._loader(
            self._make(self.cfg["data"]["validation"], "validation"),
            self.cfg["train"]["batch_size"])


dataloaders = {"KITTI": TemporalKittiDataModule}
dataloaders_refine = {"KITTI": TemporalKittiRefineDataModule}
