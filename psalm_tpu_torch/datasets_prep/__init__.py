"""Offline dataset preparation for psalm_tpu_torch: copies of the repo's
``datasets_prep/`` scripts that read and write RLEs through the port's
``data/coco_rle.py`` (only their imports differ, held by
``tests/test_torch_datasets_prep.py``). Run each as a module from the root
of a checkout, e.g. ``python -m psalm_tpu_torch.datasets_prep.build_davis
--help``."""
