"""HSL020 exchange-surface typing corpus (torch counterpart): paths and
primitives cross a TaskPool boundary; a tensor, a CUDA stream or a CUDA
event never does (a card's memory and handles do not pickle into
another process)."""

import torch

SPAWN_ENTRY_POINTS = {
    "hsl020.task_entry": ("task_body", "corpus task body"),
}


class TaskPool:
    def submit(self, task_id, fn, *args):
        pass

    def join(self):
        return {}


def task_entry(paths):
    return {"n": len(paths)}


def coordinator(files):
    pool = TaskPool()
    pool.submit(0, task_entry, [str(f) for f in files])  # clean: paths cross
    pool.submit(1, task_entry, torch.empty(3))  # expect: HSL020
    stream = torch.cuda.Stream()
    pool.submit(2, task_entry, stream)  # expect: HSL020
    pool.submit(3, task_entry, torch.cuda.Event())  # expect: HSL020
    pool.submit(4, task_entry, torch.cuda.is_available())  # clean: a bool
    pool.submit(5, task_entry, str(torch.device("cuda")))  # clean: a string
    return pool.join()
