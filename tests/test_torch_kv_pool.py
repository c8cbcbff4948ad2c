"""The page pool over the port's torch arena: the in-place page operations
that replace the reference's jnp rebuilds (defrag's batched gather,
copy-on-write's page copy, the sanitizer's poison/unpoison) keep storage
consistent with the pool's block tables."""

import torch

from repro_torch.serving import KVArena, KVBlockPool


def _arena(num_blocks, bs=2):
    L, KVH, hd = 2, 1, 3
    leaves = {"k": torch.zeros((L, num_blocks + 1, bs, KVH, hd)),
              "v": torch.zeros((L, num_blocks + 1, bs, KVH, hd))}
    return KVArena(leaves, bs)


def _fill(arena, page, value):
    for leaf in arena.leaves.values():
        leaf[:, page] = value


def test_defrag_moves_storage_with_tables():
    pool = KVBlockPool(6, 2)
    arena = _arena(6)
    pool.bind_arena(arena)
    pool.alloc("a", 4)                     # pages 0, 1
    pool.alloc("b", 4)                     # pages 2, 3
    pool.alloc("c", 2)                     # page 4
    for rid, v in (("a", 1.0), ("b", 2.0), ("c", 3.0)):
        for page in pool.table(rid).blocks:
            _fill(arena, page, v)
    pool.free("b")
    moves = pool.defrag()
    assert moves == {4: 2}
    assert pool.table("c").blocks == [2]
    for name in ("k", "v"):
        assert torch.all(arena.leaves[name][:, 2] == 3.0)
        assert torch.all(arena.leaves[name][:, 0] == 1.0)
    pool.check()


def test_copy_on_write_and_poison():
    pool = KVBlockPool(4, 2, sanitize=True)
    arena = _arena(4)
    pool.bind_arena(arena)
    t = pool.alloc("a", 2)
    _fill(arena, t.blocks[0], 5.0)
    pool.share("b", t.blocks)              # one page, two owners
    new = pool.ensure_writable("b", 0)
    assert new != t.blocks[0]
    assert torch.all(arena.leaves["k"][:, new] == 5.0)
    pool.free("a")                         # last reference: poisoned
    assert torch.isnan(arena.leaves["v"][:, t.blocks[0]]).all()
    c = pool.alloc("c", 6)                 # takes every free page back,
    assert t.blocks[0] in c.blocks         # unpoisoning each
    assert torch.all(arena.leaves["k"][:, t.blocks[0]] == 0.0)
    assert not torch.isnan(arena.leaves["k"][:, arena.trash_block]).any()
    pool.check()
