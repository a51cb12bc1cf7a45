"""Dataset preparation: text ratings -> the binary CSR/CSC/COO contract.

A copy of the JAX package's data/prepare.py on the port's utils/io.py:
parse "user sep item sep rating" triplets (1-based), hold out a test
split, and write R_train_{csr,csc}.{data,indices,indptr}.bin,
R_train_coo.row.bin and R_test_coo.{data,row,col}.bin. For the same
input and arguments the files are byte for byte the JAX module's. Point
--input at a local ratings file, or use --synthetic <workload> to write
a synthetic data set of a workload's shape.

Usage:
    python -m cumf_als_tpu_torch.data.prepare --input ratings.dat \\
        --sep '::' --m 71567 --n 65133 --test-size 1000006 --out data/ml10M
    python -m cumf_als_tpu_torch.data.prepare --synthetic ml10m \\
        --scale 0.1 --out data/ml10M_synth
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from cumf_als_tpu_torch.utils.io import COOMatrix, coo_to_csr, write_dataset


def load_triplets(path: str, sep: str = "::"):
    """Parse 'user sep item sep rating[ sep timestamp]' lines (1-based
    ids, like the ML-10M ratings.dat the reference consumes)."""
    users, items, ratings = [], [], []
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            parts = line.split(sep) if sep != " " else line.split()
            users.append(int(parts[0]))
            items.append(int(parts[1]))
            ratings.append(float(parts[2]))
    return (np.asarray(users, np.int64), np.asarray(items, np.int64),
            np.asarray(ratings, np.float32))


def prepare(users, items, ratings, m=None, n=None, test_size=0,
            seed=42, one_based=True):
    """Split + convert. seed=42 mirrors the reference's
    train_test_split(random_state=42)."""
    if one_based:
        users = users - 1
        items = items - 1
    m = int(users.max()) + 1 if m is None else m
    n = int(items.max()) + 1 if n is None else n
    total = users.shape[0]
    rng = np.random.RandomState(seed)
    te = np.zeros(total, bool)
    if test_size:
        te[rng.choice(total, size=test_size, replace=False)] = True
    tr = ~te
    train = coo_to_csr(COOMatrix(row=users[tr].astype(np.int32),
                                 col=items[tr].astype(np.int32),
                                 data=ratings[tr], num_rows=m,
                                 num_cols=n))
    test = COOMatrix(row=users[te].astype(np.int32),
                     col=items[te].astype(np.int32), data=ratings[te],
                     num_rows=m, num_cols=n)
    return train, test


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input", help="ratings text file")
    p.add_argument("--sep", default="::")
    p.add_argument("--synthetic", choices=["ml10m", "netflix", "yahoo"],
                   help="emit a synthetic shape-matched dataset instead")
    p.add_argument("--scale", type=float, default=1.0)
    p.add_argument("--m", type=int, default=None)
    p.add_argument("--n", type=int, default=None)
    p.add_argument("--test-size", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)

    if args.synthetic:
        from cumf_als_tpu_torch.data.synthetic import workload_ratings
        train, test = workload_ratings(args.synthetic, scale=args.scale,
                                       seed=args.seed)
    elif args.input:
        users, items, ratings = load_triplets(args.input, args.sep)
        train, test = prepare(users, items, ratings, args.m, args.n,
                              args.test_size, args.seed)
    else:
        p.error("need --input or --synthetic")
    write_dataset(args.out, train, test)
    print(f"wrote {args.out}: m={train.num_rows} n={train.num_cols} "
          f"nnz={train.nnz} nnz_test={test.nnz}")
    print(f"CLI: python -m cumf_als_tpu_torch.cli {train.num_rows} "
          f"{train.num_cols} 100 {train.nnz} {test.nnz} 0.05 1 1 "
          f"{args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
