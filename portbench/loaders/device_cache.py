"""The CLI's default loader: ``DeviceResidentLoader``, the whole study on
the card, each batch gathered there by index."""


def build(data: dict, traffic: dict, seed: int, device):
    from vaegam_tpu_torch.data import DeviceResidentLoader

    return DeviceResidentLoader.from_arrays(
        data["volumes"], data["covariates"], data["subjid"], data["vol_num"],
        batch_size=traffic["batch_size"], shuffle=True, seed=seed, device=device)


def one_batch(loader, k: int, seed: int):
    """A view over `loader`'s device cache (no second upload) whose epochs
    hold one batch: the k-th of the epoch-0 order that `build` gives it."""
    from vaegam_tpu_torch.data import DeviceResidentLoader

    class OneBatch(DeviceResidentLoader):
        def set_epoch(self, epoch):
            super().set_epoch(0)

        def iter_index_batches(self):
            yield list(super().iter_index_batches())[k]

    view = OneBatch.sharing_cache(loader, shuffle=True, seed=seed)
    view.set_epoch(0)
    return view
