"""Results-table CLI of the PyTorch port (the counterpart of the root
``print_results.py``): aggregates each finished experiment's
``eval_{split}_metrics.json`` + config into a markdown/csv table.

    python -m bergen_tpu_torch.print_results --folder experiments/ --format simple

It uses the standard library (and PyYAML, as ``confy`` does) where the root
script uses pandas: the same rows, columns and values, printed as pandas'
``DataFrame.to_markdown(floatfmt=".2f")`` prints them (tabulate's ``pipe``
format: a column of numbers right-aligned on the decimal point, a missing
value as ``nan``, a column holding numbers and missing values as floats).
Rows are sorted stably.
"""

import argparse
import csv
import json
import math
import os
import re
from pathlib import Path

import yaml

NAN = float("nan")


def get_config(path, split):
    with open(path) as f:
        config = yaml.safe_load(f)
    ds = config["dataset"][split]
    dataset_query = ds["query"]["init_args"]["_target_"].rsplit(".", 1)[-1]

    def model_name(section):
        node = config.get(section)
        if node and node.get("init_args"):
            return node["init_args"].get("model_name")
        return None

    return {
        "query_dataset": dataset_query,
        "Retriever": os.path.basename(model_name("retriever") or "None"),
        "Reranker": os.path.basename(model_name("reranker") or "None"),
        "Generator": os.path.basename(model_name("generator") or "None"),
    }


def collect(folder: str, split: str):
    rows = []
    for exp in Path(folder).iterdir():
        if not exp.is_dir() or "tmp_" in exp.name:
            continue
        metrics_file = exp / f"eval_{split}_metrics.json"
        if not metrics_file.exists():
            continue
        try:
            row = {"exp_folder": exp.name}
            row.update(get_config(exp / "config.yaml", split))
            with open(metrics_file) as f:
                row.update(json.load(f))
            time_file = exp / f"eval_{split}_generation_time.json"
            if time_file.exists():
                with open(time_file) as f:
                    row["gen_time"] = json.load(f)["Generation time"]
            rank_file = exp / f"eval_{split}_ranking_metrics.json"
            if rank_file.exists():
                with open(rank_file) as f:
                    row["P_1"] = json.load(f)["P_1"]
            rows.append(row)
        except Exception as e:  # noqa: BLE001 - report and go on, as the root script
            print(f"Skipping {exp} due to parsing errors: {e}")
    return rows


# --------------------------------------------------------------------------- #
# the table: pandas' columns, then tabulate's pipe format
# --------------------------------------------------------------------------- #


def _is_number(v) -> bool:
    return isinstance(v, (int, float)) and not isinstance(v, bool)


def frame_column(rows, name):
    """One column as pandas builds it from ``rows``: a missing value is NaN,
    and a column of numbers that are not all integers, or that misses a
    value, holds floats."""
    values = [r.get(name, NAN) for r in rows]
    present = [r[name] for r in rows if name in r and r[name] is not None]
    if present and all(map(_is_number, present)) and (
            len(present) < len(values)
            or any(isinstance(v, float) for v in present)):
        return [float(v) if _is_number(v) else NAN for v in values]
    return [NAN if v is None else v for v in values]


_THOUSANDS = re.compile(
    r"^(([+-]?[0-9]{1,3})(?:,([0-9]{3}))*)?(?(1)\.[0-9]*|\.[0-9]+)?$")


def _converts(conv, s) -> bool:
    try:
        conv(s)
        return True
    except (ValueError, TypeError):
        return False


def _isnumber(s) -> bool:
    if type(s) in (float, int):
        return True
    if not _converts(float, s):
        return False
    if not isinstance(s, str):
        return True
    f = float(s)
    return not (math.isinf(f) or math.isnan(f)) or s.lower() in (
        "inf", "-inf", "nan")


def _isint(s) -> bool:
    return type(s) is int or (isinstance(s, str) and _converts(int, s))


def _thousands(s) -> bool:
    return isinstance(s, str) and bool(_THOUSANDS.match(s))


def _cell_type(v):
    """tabulate's ``_type``: None, bool, int, float or str."""
    if v is None or (isinstance(v, str) and not v):
        return type(None)
    if type(v) is bool or (isinstance(v, str) and v in ("True", "False")):
        return bool
    if _isint(v) or (_thousands(v) and "." not in v):
        return int
    if _isnumber(v) or _thousands(v):
        return float
    return str


_GENERIC = (type(None), bool, int, float, str)


def _format(v, ctype, floatfmt):
    if v is None:
        return ""
    if isinstance(v, str) and not v:
        return ""
    if ctype is int:
        return format(v, "")
    if ctype is float:
        try:
            return format(float(v.replace(",", "") if isinstance(v, str)
                                else v), floatfmt)
        except (ValueError, TypeError):
            return f"{v}"
    return f"{v}"


def _afterpoint(s) -> int:
    if (_isnumber(s) or _thousands(s)) and not _isint(s):
        pos = s.rfind(".")
        pos = s.lower().rfind("e") if pos < 0 else pos
        return len(s) - pos - 1 if pos >= 0 else -1
    return -1


def to_markdown(header, columns, floatfmt=".2f") -> str:
    """tabulate(rows, headers, tablefmt="pipe", floatfmt=floatfmt) of the
    given columns (the index first)."""
    cells, aligns = [], []
    for col in columns:
        ctype = max((_cell_type(v) for v in col), key=_GENERIC.index,
                    default=type(None))
        ctype = bool if ctype is type(None) else ctype
        strs = [_format(v, ctype, floatfmt) for v in col]
        if ctype in (int, float):
            dec = [_afterpoint(s) for s in strs]
            strs = [s + (max(dec) - d) * " " for s, d in zip(strs, dec)]
            aligns.append("right")
        else:
            strs = [s.strip() for s in strs]
            aligns.append("left")
        cells.append(strs)
    widths = [max([len(h) + 2] + [len(s) for s in c])
              for h, c in zip(header, cells)]

    def pad(s, width, align):
        return s.rjust(width) if align == "right" else s.ljust(width)

    lines = ["|" + "|".join(f" {pad(h, w, a)} " for h, w, a
                            in zip(header, widths, aligns)) + "|"]
    lines.append("|" + "|".join(
        ("-" * (w + 1) + ":") if a == "right" else (":" + "-" * (w + 1))
        for w, a in zip(widths, aligns)) + "|")
    for i in range(len(columns[0])):
        lines.append("|" + "|".join(
            f" {pad(c[i], w, a)} " for c, w, a in zip(cells, widths, aligns))
            + "|")
    return "\n".join(lines)


def _sort_key(v):
    missing = v is None or (isinstance(v, float) and math.isnan(v))
    return (missing, 0 if missing else v)


def main(args):
    rows = collect(args.folder, args.split)
    if not rows:
        print(f'No results in folder "{args.folder}" yet!')
        return
    names = list(dict.fromkeys(k for r in rows for k in r))
    llmeval_cols = [c for c in names if "llmeval" in c.lower()]
    base = ["exp_folder", "query_dataset", "Generator", "Retriever", "Reranker"]
    if args.format == "tiny":
        sel = base + ["M"] + llmeval_cols
    elif args.format == "simple":
        sel = base + ["M", "EM", "Recall"] + llmeval_cols
    elif args.format == "full":
        sel = (
            ["exp_folder", "Retriever", "P_1", "Reranker", "Generator",
             "gen_time", "query_dataset", "M", "EM", "F1", "Precision",
             "Recall", "Recall_char3gram", "Rouge-L"] + llmeval_cols
        )
    else:
        raise ValueError("Invalid output format")
    sel = [c for c in sel if c in names]
    table = {c: frame_column(rows, c) for c in sel}
    by = args.sort if args.sort in sel else sel[0]
    order = sorted(range(len(rows)), key=lambda i: _sort_key(table[by][i]))
    columns = [order] + [[table[c][i] for i in order] for c in sel]
    print("Split:", args.split)
    print(to_markdown([""] + sel, columns))
    if args.csv:
        os.makedirs("results", exist_ok=True)
        path = f"results/{args.folder.replace('/', '_')}.csv"
        with open(path, "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(sel)
            for i in order:
                w.writerow(["" if isinstance(v, float) and math.isnan(v)
                            else v for v in (table[c][i] for c in sel)])


def cli(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--folder", type=str, default="experiments")
    parser.add_argument("--split", type=str, default="dev")
    parser.add_argument("--format", type=str, default="simple",
                        choices=["simple", "tiny", "full"])
    parser.add_argument("--sort", type=str, default="Generator")
    parser.add_argument("--csv", action="store_true")
    main(parser.parse_args(argv))


if __name__ == "__main__":
    cli()
