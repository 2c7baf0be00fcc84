"""The abstract task (counterpart of ``ssrg_tpu/train/base_task.py``)."""

from __future__ import annotations


class BaseTask:
    def execute(self, *args, **kwargs):
        raise NotImplementedError

    def evaluate(self, *args, **kwargs):
        raise NotImplementedError

    def train(self, *args, **kwargs):
        raise NotImplementedError
