"""One process: the collectives the copied modules call, as identities."""


def is_distributed() -> bool:
    return False


def world_size() -> int:
    return 1


def rank_rows(x, dim=0):
    return x


def global_sum(x):
    return x


def all_reduce_sum(x):
    return x
