"""Per-dataset raw-dump converters — the port of the JAX package's
`utils/convert.py` (plain Python, byte for byte the same files). Capability parity with the
reference's vendored RecBole conversion tool
(`util/knowledge/conversion_tools/src/extended_dataset.py`, ~5.2k LoC of
per-dataset classes) scoped to the datasets the reference CLI actually
supports (`main.py:18`: lastfm, ml-1m, amazon_books, steam, yelp).

Two output surfaces per dataset:

1. **Atomic files** (RecBole interchange format): `<name>.inter` (+
   `.item`/`.user` where the raw dump carries side features) — TSV with a
   `field:type` header line, types in {token, token_seq, float}. This is
   the format `make_kg_subset` (dataset_tools.py) links against and the
   format the reference's `add_knowledge.py` consumes.
2. **Training format**: `ratings.txt` — `user \t item \t weight` with no
   header, weight 1.0, the format `FileIO.load_data_set` reads
   (reference `data/loader.py:24-38`). Produced via `atomic_to_ratings`
   with optional rating threshold and iterative k-core filtering (the
   reference's LastFM "as trained" shapes, 1,890 x 14,777 from
   1,892 x 17,632 raw, come from exactly this kind of filtering).

Unlike the vendored tool these are streaming line converters (no pandas
dataframe materialisation of a 25M-row review dump) and one function per
dataset instead of a 100-line class.

CLI:
    python -m hypergraph_diffusion_for_recommendation_tpu_torch.utils.convert \
        --dataset ml-1m --input <raw dir> --output <out dir> \
        [--min_rating 4.0 --k_core 5]
"""

from __future__ import annotations

import argparse
import ast
import json
import os
from collections import Counter
from typing import Callable, Iterable, Iterator, TextIO


# ---------------------------------------------------------------------------
# atomic-file primitives


def write_atomic(path: str, header: list[str], rows: Iterable[list[str]]) -> int:
    """Write a RecBole atomic file; returns the row count."""
    for field in header:
        name, _, ftype = field.partition(":")
        if ftype not in ("token", "token_seq", "float"):
            raise ValueError(f"bad atomic field {field!r}")
        if not name:
            raise ValueError(f"bad atomic field {field!r}")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = 0
    with open(path, "w") as fp:
        fp.write("\t".join(header) + "\n")
        for row in rows:
            if len(row) != len(header):
                raise ValueError(f"row width {len(row)} != header {len(header)}")
            fp.write("\t".join(row) + "\n")
            n += 1
    return n


def read_atomic(path: str) -> tuple[list[str], list[list[str]]]:
    """Read a RecBole atomic file -> (header fields, rows)."""
    with open(path) as fp:
        header = fp.readline().rstrip("\n").split("\t")
        rows = [line.rstrip("\n").split("\t") for line in fp if line.strip()]
    return header, rows


def _field_index(header: list[str], name: str) -> int:
    for i, field in enumerate(header):
        if field.partition(":")[0] == name:
            return i
    raise KeyError(f"field {name!r} not in {header}")


# ---------------------------------------------------------------------------
# training-format export (atomic .inter -> ratings.txt)


def kcore_filter(
    pairs: list[tuple[str, str]], k: int
) -> list[tuple[str, str]]:
    """Iterative k-core: drop users/items with < k interactions until
    stable. Standard implicit-feedback preprocessing (the reference's
    committed LastFM shapes imply it; RecBole calls it
    `user_inter_num_interval`/`item_inter_num_interval`)."""
    while True:
        uc = Counter(u for u, _ in pairs)
        ic = Counter(i for _, i in pairs)
        kept = [(u, i) for u, i in pairs if uc[u] >= k and ic[i] >= k]
        if len(kept) == len(pairs):
            return kept
        pairs = kept


def atomic_to_ratings(
    inter_path: str,
    out_path: str,
    user_field: str = "user_id",
    item_field: str = "item_id",
    rating_field: str | None = "rating",
    min_rating: float = 0.0,
    k_core: int = 0,
    dedup: bool = True,
) -> int:
    """Atomic .inter -> reference `user \\t item \\t weight` training file
    (header line + weight forced 1.0, exactly the shape
    `FileIO.load_data_set` reads, reference data/loader.py:24-38; our
    `data.io.load_data_set` skips the header and parses int64 ids).
    Datasets with non-integer raw ids (amazon/yelp/steam hashes) are
    remapped to dense first-appearance integers, with the mapping written
    to `<out>.user_map` / `<out>.item_map` sidecars. Returns the
    kept-interaction count."""
    header, rows = read_atomic(inter_path)
    ui = _field_index(header, user_field)
    ii = _field_index(header, item_field)
    ri = None
    if rating_field is not None:
        try:
            ri = _field_index(header, rating_field)
        except KeyError:
            ri = None
    pairs: list[tuple[str, str]] = []
    seen: set[tuple[str, str]] = set()
    for row in rows:
        if ri is not None and min_rating > 0 and float(row[ri]) < min_rating:
            continue
        key = (row[ui], row[ii])
        if dedup:
            if key in seen:
                continue
            seen.add(key)
        pairs.append(key)
    if k_core > 0:
        pairs = kcore_filter(pairs, k_core)

    def _all_int(tokens: Iterable[str]) -> bool:
        return all(t.lstrip("-").isdigit() for t in tokens)

    os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
    for side, raw_ids in (("user", [u for u, _ in pairs]),
                          ("item", [i for _, i in pairs])):
        if _all_int(set(raw_ids)):
            continue
        remap: dict[str, int] = {}
        for rid in raw_ids:
            if rid not in remap:
                remap[rid] = len(remap)
        with open(f"{out_path}.{side}_map", "w") as fp:
            for rid, dense in remap.items():
                fp.write(f"{rid}\t{dense}\n")
        if side == "user":
            pairs = [(str(remap[u]), i) for u, i in pairs]
        else:
            pairs = [(u, str(remap[i])) for u, i in pairs]

    with open(out_path, "w") as fp:
        fp.write("user\titem\tweight\n")
        for u, i in pairs:
            fp.write(f"{u}\t{i}\t1.0\n")
    return len(pairs)


# ---------------------------------------------------------------------------
# per-dataset converters
#
# Each returns {atomic kind: (path, n_rows)} and never loads the full raw
# dump into memory.


def _open(input_dir: str, *names: str) -> TextIO:
    """Open the first existing candidate raw file."""
    for name in names:
        path = os.path.join(input_dir, name)
        if os.path.exists(path):
            return open(path, errors="replace")
    raise FileNotFoundError(f"none of {names} under {input_dir}")


def convert_ml1m(input_dir: str, output_dir: str) -> dict[str, tuple[str, int]]:
    """MovieLens-1M: `::`-separated ratings.dat/movies.dat/users.dat
    (reference ML1MDataset, extended_dataset.py:84-138; title/year split
    and genre `|` -> space preserved)."""
    out: dict[str, tuple[str, int]] = {}

    def inter_rows() -> Iterator[list[str]]:
        with _open(input_dir, "ratings.dat") as fp:
            for line in fp:
                u, i, r, ts = line.rstrip("\n").split("::")
                yield [u, i, r, ts]

    path = os.path.join(output_dir, "ml-1m.inter")
    out["inter"] = (path, write_atomic(
        path,
        ["user_id:token", "item_id:token", "rating:float", "timestamp:float"],
        inter_rows(),
    ))

    def item_rows() -> Iterator[list[str]]:
        with _open(input_dir, "movies.dat") as fp:
            for line in fp:
                mid, title, genres = line.rstrip("\n").split("::")
                year = ""
                name = title
                lp, rp = title.rfind("("), title.rfind(")")
                if 0 <= lp < rp:
                    year = title[lp + 1 : rp]
                    name = title[:lp].rstrip()
                yield [mid, name, year, genres.replace("|", " ")]

    path = os.path.join(output_dir, "ml-1m.item")
    out["item"] = (path, write_atomic(
        path,
        ["item_id:token", "movie_title:token_seq", "release_year:token",
         "genre:token_seq"],
        item_rows(),
    ))

    def user_rows() -> Iterator[list[str]]:
        with _open(input_dir, "users.dat") as fp:
            for line in fp:
                yield line.rstrip("\n").split("::")

    path = os.path.join(output_dir, "ml-1m.user")
    out["user"] = (path, write_atomic(
        path,
        ["user_id:token", "gender:token", "age:token", "occupation:token",
         "zip_code:token"],
        user_rows(),
    ))
    return out


def convert_lastfm(input_dir: str, output_dir: str) -> dict[str, tuple[str, int]]:
    """LastFM (HetRec 2011): tab-separated user_artists.dat with a header
    (userID artistID weight) + optional artists.dat side file. This is the
    dataset behind every committed reference number (BASELINE.md)."""
    out: dict[str, tuple[str, int]] = {}

    def inter_rows() -> Iterator[list[str]]:
        with _open(input_dir, "user_artists.dat") as fp:
            fp.readline()  # header
            for line in fp:
                u, a, w = line.rstrip("\n").split("\t")[:3]
                yield [u, a, w]

    path = os.path.join(output_dir, "lastfm.inter")
    out["inter"] = (path, write_atomic(
        path,
        ["user_id:token", "artist_id:token", "listen_count:float"],
        inter_rows(),
    ))

    try:
        def item_rows() -> Iterator[list[str]]:
            with _open(input_dir, "artists.dat") as fp:
                fp.readline()
                for line in fp:
                    parts = line.rstrip("\n").split("\t")
                    yield [parts[0], parts[1] if len(parts) > 1 else ""]

        path = os.path.join(output_dir, "lastfm.item")
        out["item"] = (path, write_atomic(
            path, ["artist_id:token", "name:token_seq"], item_rows()))
    except FileNotFoundError:
        pass
    return out


def convert_amazon_books(
    input_dir: str, output_dir: str
) -> dict[str, tuple[str, int]]:
    """Amazon Books ratings-only CSV `user,item,rating,timestamp`
    (reference AmazonBooksDataset, extended_dataset.py:2367-2412)."""

    def inter_rows() -> Iterator[list[str]]:
        with _open(input_dir, "ratings_Books.csv", "ratings.csv") as fp:
            for line in fp:
                parts = line.rstrip("\n").split(",")
                if len(parts) >= 4:
                    yield parts[:4]

    path = os.path.join(output_dir, "amazon-books.inter")
    return {"inter": (path, write_atomic(
        path,
        ["user_id:token", "item_id:token", "rating:float", "timestamp:float"],
        inter_rows(),
    ))}


def convert_yelp(input_dir: str, output_dir: str) -> dict[str, tuple[str, int]]:
    """Yelp academic dataset: JSON-lines review dump (reference
    YELPDataset, extended_dataset.py:4254-4290). Streams; keeps the
    ranking-relevant fields only."""

    def inter_rows() -> Iterator[list[str]]:
        with _open(
            input_dir, "yelp_academic_dataset_review.json", "review.json"
        ) as fp:
            for line in fp:
                if not line.strip():
                    continue
                rec = json.loads(line)
                yield [
                    str(rec["user_id"]),
                    str(rec["business_id"]),
                    str(rec.get("stars", 1.0)),
                    str(rec.get("date", "")),
                ]

    path = os.path.join(output_dir, "yelp.inter")
    return {"inter": (path, write_atomic(
        path,
        ["user_id:token", "business_id:token", "stars:float", "date:token"],
        inter_rows(),
    ))}


def convert_steam(input_dir: str, output_dir: str) -> dict[str, tuple[str, int]]:
    """Steam reviews: python-literal lines (single-quoted dicts — the raw
    dump is not valid JSON; reference STEAMDataset eval()s them,
    extended_dataset.py:1563-1588 — literal_eval here). Username stands in
    for user id exactly as in the reference's user_dict mapping."""

    def inter_rows() -> Iterator[list[str]]:
        with _open(input_dir, "steam_reviews.json", "steam_new.json") as fp:
            for line in fp:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = ast.literal_eval(line)
                except (ValueError, SyntaxError):
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                user = rec.get("username") or rec.get("user_id")
                prod = rec.get("product_id")
                if user is None or prod is None:
                    continue
                yield [
                    str(user),
                    str(prod),
                    str(rec.get("hours", 0.0)),
                    str(rec.get("date", "")),
                ]

    path = os.path.join(output_dir, "steam.inter")
    return {"inter": (path, write_atomic(
        path,
        ["user_id:token", "product_id:token", "play_hours:float",
         "date:token"],
        inter_rows(),
    ))}


CONVERTERS: dict[str, Callable[[str, str], dict[str, tuple[str, int]]]] = {
    "ml-1m": convert_ml1m,
    "lastfm": convert_lastfm,
    "amazon-books": convert_amazon_books,
    "yelp": convert_yelp,
    "steam": convert_steam,
}

# .inter field names per dataset, for the ratings.txt export
_RATING_FIELDS: dict[str, tuple[str, str, str | None]] = {
    "ml-1m": ("user_id", "item_id", "rating"),
    "lastfm": ("user_id", "artist_id", "listen_count"),
    "amazon-books": ("user_id", "item_id", "rating"),
    "yelp": ("user_id", "business_id", "stars"),
    "steam": ("user_id", "product_id", None),
}


def convert_dataset(
    name: str,
    input_dir: str,
    output_dir: str,
    min_rating: float = 0.0,
    k_core: int = 0,
) -> dict[str, tuple[str, int]]:
    """Raw dump -> atomic files + ratings.txt in one call."""
    if name not in CONVERTERS:
        raise KeyError(f"unknown dataset {name!r}; have {sorted(CONVERTERS)}")
    out = CONVERTERS[name](input_dir, output_dir)
    uf, if_, rf = _RATING_FIELDS[name]
    ratings_path = os.path.join(output_dir, "ratings.txt")
    n = atomic_to_ratings(
        out["inter"][0], ratings_path,
        user_field=uf, item_field=if_, rating_field=rf,
        min_rating=min_rating, k_core=k_core,
    )
    out["ratings"] = (ratings_path, n)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataset", required=True, choices=sorted(CONVERTERS))
    ap.add_argument("--input", required=True, help="raw dump directory")
    ap.add_argument("--output", required=True)
    ap.add_argument("--min_rating", type=float, default=0.0,
                    help="drop interactions rated below this (0 = keep all)")
    ap.add_argument("--k_core", type=int, default=0,
                    help="iterative k-core filter on the ratings export")
    args = ap.parse_args(argv)
    out = convert_dataset(
        args.dataset, args.input, args.output,
        min_rating=args.min_rating, k_core=args.k_core,
    )
    for kind, (path, n) in sorted(out.items()):
        print(f"{kind}: {path} ({n:,} rows)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
