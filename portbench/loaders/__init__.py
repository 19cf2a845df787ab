"""Loaders by the name a traffic file gives (``"loader"``): ``<name>.py``
holds ``build(data, traffic, seed, device)``, which returns the loader the
window's epochs read, and ``one_batch(loader, k, seed)``, which returns a loader
over the same data that holds only the k-th batch of its epoch-0 order
(the checked steps: one ``Trainer.train_epoch`` each)."""
