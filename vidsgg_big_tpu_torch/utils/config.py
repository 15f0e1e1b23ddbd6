"""Python-file config loader (same public contract as the reference).

Experiment configs are plain ``.py`` files defining dicts (``model_config``,
``train_dataset_config``, ``test_dataset_config``, ``train_config``,
``inference_config``); they are loaded by importing a temporary copy
(reference utils/utils_func.py:15-42) so configs may use arbitrary python.
"""
from __future__ import annotations

import os
import shutil
import sys
import tempfile
from importlib import import_module


def parse_config_py(filename: str) -> dict:
    filename = os.path.abspath(os.path.expanduser(filename))
    assert filename.endswith(".py"), filename
    with tempfile.TemporaryDirectory() as temp_dir:
        temp_file = tempfile.NamedTemporaryFile(dir=temp_dir, suffix=".py")
        temp_name = os.path.basename(temp_file.name)
        shutil.copyfile(filename, os.path.join(temp_dir, temp_name))
        temp_module = os.path.splitext(temp_name)[0]
        sys.path.insert(0, temp_dir)
        try:
            mod = import_module(temp_module)
        finally:
            sys.path.pop(0)
        cfg = {k: v for k, v in mod.__dict__.items()
               if not k.startswith("__")}
        del sys.modules[temp_module]
        temp_file.close()
    return cfg
