"""Alignment options — the equivalent of bwa-mem's ``mem_opt_t``.

Defaults mirror bwa-mem2's ``mem_opt_init()`` (reference: [src] bwamem.cpp;
surveyed via SURVEY.md §5 "Config / flag system": CLI flags `-t`, `-k`, and
hard-coded tunables `MAX_SEED_HITS`, `BATCH_THRESHOLD`, `MAX_SEQ_LEN8` are all
surfaced here as config fields).
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

PLATFORMS = ("cpu", "gpu")  # JAX platforms with a preset


@dataclasses.dataclass
class MemOptions:
    # scoring
    a: int = 1                  # match score
    b: int = 4                  # mismatch penalty
    o_del: int = 6              # gap open (deletion)
    e_del: int = 1              # gap extend (deletion)
    o_ins: int = 6              # gap open (insertion)
    e_ins: int = 1              # gap extend (insertion)
    pen_unpaired: int = 17      # phred-scaled penalty for unpaired reads
    pen_clip5: int = 5
    pen_clip3: int = 5
    w: int = 100                # band width
    zdrop: int = 100            # Z-dropoff

    # seeding
    min_seed_len: int = 19
    split_width: int = 10
    split_factor: float = 1.5
    max_mem_intv: int = 20      # 3rd-round (LAST-like) seeding occ cap; 0 disables
    max_occ: int = 500          # skip a seed if its SMEM has more occurrences

    # chaining
    max_chain_gap: int = 10000
    min_chain_weight: int = 0
    max_chain_extend: int = 1 << 30
    mask_level: float = 0.50
    drop_ratio: float = 0.50
    mask_level_redun: float = 0.95

    # output
    T: int = 30                 # minimum score to output
    mapQ_coef_len: int = 50
    max_XA_hits: int = 5
    XA_drop_ratio: float = 0.80

    # pairing
    max_ins: int = 10000
    max_matesw: int = 50

    # pipeline / device batching (no reference analog except kthread batch
    # sizes — SURVEY.md §2 kt_for ARM_BATCH_SIZE lesson: small balanced
    # batches)
    batch_reads: int = 8192        # reads per device batch
    mesh_shape: tuple = ()         # device mesh for data-parallel sharding
    #                                (empty = single device)
    shard_sa: bool = False         # shard the suffix array over the mesh
    #                                (GRCh38-scale serving: the SA doesn't
    #                                fit one card; ops.fm.sa_lookup_sharded)
    sa_sample_shift: int = 0       # sampled-SA serving: keep every SA row
    #                                whose suffix position % 2^shift == 0
    #                                on device (1/2^shift the memory) and
    #                                LF-walk the rest (<= 2^shift-1 fused
    #                                gathers/lookup, exact results) — the
    #                                single-card route for genomes whose
    #                                full SA exceeds device memory (ops.fm
    #                                sa_lookup_sampled).  0 = full SA.
    max_read_len: int = 160        # static padded read length on device
    max_smems_per_read: int = 64   # static SMEM capacity per read
    max_seeds_per_read: int = 128  # static seed capacity per read
    pad_tail_full: bool = False    # pad tail batches to batch_reads so the
    #                                whole run uses ONE seeding shape family
    #                                (each extra shape is another cold
    #                                compile; a padded tail is masked device
    #                                work).  Set by the platform presets;
    #                                off by default so small API/test
    #                                batches stay small.

    @property
    def mapQ_coef_fac(self) -> float:
        return math.log(self.mapQ_coef_len)

    @classmethod
    def preset(cls, platform: str, n_devices: int = 1,
               **overrides) -> "MemOptions":
        """Batch and mesh for ``n_devices`` devices of a JAX platform — the
        reference's runtime dispatcher picked a binary per CPU generation
        ([src] runsimd_arm.cpp, SURVEY.md §2.1); here the devices pick the
        device batch and the data-parallel mesh.

        "gpu": 8192 reads per card, reads data-parallel over a ("dp",) mesh
        of all the cards when there is more than one.  8192 is a starting
        value, not a measurement: the batch sweep on the card is still to
        be done.  "cpu": 256 reads, one device.  Any other platform has no
        preset and raises."""
        if platform == "gpu":
            n = int(n_devices)
            cfg = dict(batch_reads=8192 * n, pad_tail_full=True,
                       mesh_shape=(n,) if n > 1 else ())
        elif platform == "cpu":
            cfg = dict(batch_reads=256, pad_tail_full=True)
        else:
            raise ValueError(f"no preset for JAX platform {platform!r}; "
                             f"supported: {', '.join(PLATFORMS)}")
        cfg.update(overrides)
        return cls(**cfg)

    @classmethod
    def auto(cls, **overrides) -> "MemOptions":
        """The preset for the visible devices (jax.devices())."""
        import jax

        devs = jax.devices()
        return cls.preset(devs[0].platform, len(devs), **overrides)

    @property
    def split_len(self) -> int:
        # bwa: (int)(opt->min_seed_len * opt->split_factor + .499)
        return int(self.min_seed_len * self.split_factor + 0.499)

    def score_matrix(self) -> np.ndarray:
        """5x5 scoring matrix (bwa_fill_scmat): ACGT x ACGT, row/col 4 = N.
        Memoized per (a, b) — it is requested on hot per-read paths."""
        key = (self.a, self.b)
        cached = getattr(self, "_scmat", None)
        if cached is not None and cached[0] == key:
            return cached[1]
        mat = np.full((5, 5), -1, dtype=np.int32)
        for i in range(4):
            for j in range(4):
                mat[i, j] = self.a if i == j else -self.b
        mat[4, :] = -1
        mat[:, 4] = -1
        object.__setattr__(self, "_scmat", (key, mat))
        return mat
