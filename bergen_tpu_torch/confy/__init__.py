"""confy — a minimal, dependency-free configuration system.

Replaces Hydra + OmegaConf for this framework (the reference drives everything
through hydra composition and ``hydra.utils.instantiate`` of ``init_args._target_``
nodes — see reference ``bergen.py:14-26`` and ``modules/rag.py:188``).  confy keeps
the same YAML tree layout and the same ``_target_`` semantics so configs read
identically, while being a few hundred lines of plain Python:

* ``compose(config_path, config_name, overrides)`` — loads ``<name>.yaml``,
  resolves its ``defaults:`` list (group entries like ``- retriever: null`` load
  ``retriever/<choice>.yaml`` under key ``retriever``), then applies CLI-style
  overrides (``group=choice``, ``key.sub=value``, ``+new.key=value``,
  ``~key`` deletions).
* ``Config`` — a dict with attribute access, deep merge, and YAML round-trip.
* ``instantiate(node, **kw)`` — imports ``_target_`` and constructs the object,
  recursively instantiating any nested ``_target_`` nodes.

This is the PyTorch port's own copy.  The config tree names the JAX
package's classes (``bergen_tpu.…``); ``instantiate`` maps each such target
to its port through the one explicit table ``TARGETS`` and raises, naming
the target, for one the port does not have.  The config dict itself is never
rewritten, so ``utils.hash_config`` names an experiment the same in both
packages.
"""

from __future__ import annotations

import copy
import importlib
import os
from typing import Any, Iterable

import yaml

__all__ = ["Config", "compose", "instantiate", "load_yaml", "to_yaml", "save_yaml",
           "TARGETS", "resolve_target"]

# the dataset classes of the JAX package's data modules that the config
# tree names; each has a port of the same name in the same module under
# ``bergen_tpu_torch.data``
_DATA_TARGETS = {
    "processor": ("MergedDocDataset",),
    "processors.ut": ("UT1Docs", "UT1Queries"),
    "processors.kilt": (
        "KILTNQ", "KILTHotpotqa", "KILTAidayago2", "KILTCweb", "KILTFever",
        "KILTStructuredZeroshot", "KILTSTrex", "KILTWned", "KILTWow",
        "KILTTriviaqa", "KILTEli5", "KILTMULTIQA", "KiltMultiQAMSMarco"),
    "processors.general": (
        "BIOASQ11B", "MMLU", "NQOpen", "MsMarcoQueries", "Frames",
        "ReproduceWikiCorpora63", "ODQAWikiCorpora100WTamber",
        "ODQAWikiCorpora100WKarpukhin", "ODQAWikiCorpora63tamber",
        "ODQAWikiCorpora63tamberALL", "KILT100w", "Wiki_monolingual_100w",
        "NarrativeQA", "PubMed2023", "Wikipedia2023_section",
        "Wikipedia2023_full", "MsMarcoCollection"),
    "processors.mrag": ("MKQA", "XORQA", "TydiQA"),
    "processors.qa": ("TimeSensitiveQA", "WIKIQA", "SCIQ", "ASQA",
                      "truthful_qa", "POPQA", "wikimultihopqa"),
    "processors.msmarco": ("MsMarcoFullDocCollection",
                           "MsMarcoFullDocQueries",
                           "MsMarcoFullDocChunkCollection"),
    "processors.nih": ("NIHDataset", "NIHDatasetNumber", "NIHDatasetSimple",
                       "NIHDatasetMultiHop"),
    "processors.multidomain": (
        "BIOASQ12B", "BIOASQ11B_Ragged", "PubMed2023_Ragged",
        "APIBench_gorilla_HF", "APIBench_gorilla_TF", "APIBench_gorilla_TH",
        "API_gorilla_HF", "API_gorilla_TF", "API_gorilla_TH",
        "CodeRAGBench_HumanEval", "CodeRAGBench_MBPP",
        "CodeRAGBench_programming_solutions",
        "CodeRAGBench_online_tutorials",
        "CodeRAGBench_library_documentation", "CodeRAGBench_stackoverflow",
        "CodeRAGBench_gitrepospython", "CodeRAGBench_gitrepos", "SyllabusQA",
        "SyllabusQA_syllabi", "MultiQA", "TechQA", "TechQA_docs",
        "ParaphraseRC", "ParaphraseRC_docs", "CovidQA", "CORD19", "LoTTE",
        "RobustQA_Lifestyle", "RobustQA_Recreation", "RobustQA_Science",
        "RobustQA_Technology", "RobustQA_Writing", "FiQA", "FiQA_corpus",
        "SearchQA", "SearchQA_corpus", "RGB"),
}

# JAX-package target -> port class, for every target the ported slice runs
TARGETS = {
    **{f"bergen_tpu.data.{mod}.{cls}": f"bergen_tpu_torch.data.{mod}.{cls}"
       for mod, classes in _DATA_TARGETS.items() for cls in classes},
    "bergen_tpu.models.retrievers.dense.DenseRetriever":
        "bergen_tpu_torch.models.retrievers.dense.DenseRetriever",
    "bergen_tpu.models.retrievers.splade.SpladeRetriever":
        "bergen_tpu_torch.models.retrievers.splade.SpladeRetriever",
    "bergen_tpu.models.rerankers.crossencoder.CrossEncoder":
        "bergen_tpu_torch.models.rerankers.crossencoder.CrossEncoder",
    "bergen_tpu.models.generators.jax_llm.LLM":
        "bergen_tpu_torch.models.generators.llm.LLM",
    "bergen_tpu.models.query_generators.copy.CopyQuery":
        "bergen_tpu_torch.models.query_generators.copy.CopyQuery",
    "bergen_tpu.models.retrievers.repllama.RepLlama":
        "bergen_tpu_torch.models.retrievers.repllama.RepLlama",
    "bergen_tpu.models.retrievers.bm25.BM25":
        "bergen_tpu_torch.models.retrievers.bm25.BM25",
    "bergen_tpu.models.retrievers.oracle_provenance.OracleProvenance":
        "bergen_tpu_torch.models.retrievers.oracle_provenance"
        ".OracleProvenance",
    "bergen_tpu.models.generators.oracle.OracleAnswer":
        "bergen_tpu_torch.models.generators.oracle.OracleAnswer",
    "bergen_tpu.models.generators.oracle.OracleProvenance":
        "bergen_tpu_torch.models.generators.oracle.OracleProvenance",
    "bergen_tpu.models.generators.llm_cocom.COCOM":
        "bergen_tpu_torch.models.generators.llm_cocom.COCOM",
    "bergen_tpu.models.generators.llm_xrag.XRAG":
        "bergen_tpu_torch.models.generators.llm_xrag.XRAG",
    **{f"bergen_tpu.models.{mod}.{cls}": f"bergen_tpu_torch.models.{mod}.{cls}"
       for mod, cls in (
           ("context_processors.recomp", "RecompExtractiveCompressor"),
           ("context_processors.recomp", "RecompAbstractiveCompressor"),
           ("context_processors.dslr_ce", "DSLR_CE"),
           ("context_processors.provence", "ProvenceCompressor"),
           ("context_processors.llmlingua", "LongLLMLingua"),
           ("context_processors.llmlingua", "LLMLingua2"),
           ("query_generators.translate_query", "TranslateQuery"),
           ("query_generators.unfold_api_query", "UnfoldAPIQuery"))},
}


class Config(dict):
    """Nested dict with attribute access. Missing keys raise AttributeError so
    ``cfg.get('x', default)`` and ``'x' in cfg`` work as with plain dicts."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            self[k] = _wrap(v)

    def __setitem__(self, key, value):
        super().__setitem__(key, _wrap(value))

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __deepcopy__(self, memo):
        return Config({k: copy.deepcopy(v, memo) for k, v in self.items()})

    def to_dict(self) -> dict:
        return _unwrap(self)


def _wrap(v: Any) -> Any:
    if isinstance(v, Config):
        return v
    if isinstance(v, dict):
        return Config(v)
    if isinstance(v, list):
        return [_wrap(x) for x in v]
    return v


def _unwrap(v: Any) -> Any:
    if isinstance(v, dict):
        return {k: _unwrap(x) for k, x in v.items()}
    if isinstance(v, list):
        return [_unwrap(x) for x in v]
    return v


def _deep_merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _deep_merge(dst[k], v)
        else:
            dst[k] = _wrap(copy.deepcopy(v))


def load_yaml(path: str) -> Config:
    with open(path) as f:
        data = yaml.safe_load(f)
    return Config(data or {})


def to_yaml(cfg: Any) -> str:
    return yaml.safe_dump(_unwrap(cfg), sort_keys=False, default_flow_style=False)


def save_yaml(cfg: Any, path: str) -> None:
    with open(path, "w") as f:
        f.write(to_yaml(cfg))


class MissingMandatoryValue(ValueError):
    pass


_MISSING = "??"


def _parse_value(text: str) -> Any:
    """Parse an override value with YAML scalar rules ('5'→int, 'null'→None...)."""
    try:
        return yaml.safe_load(text)
    except yaml.YAMLError:
        return text


def _set_dotted(cfg: dict, dotted: str, value: Any, *, create: bool) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        if k not in node or not isinstance(node[k], dict):
            if not create and k not in node:
                raise KeyError(
                    f"Override key '{dotted}' not found in config "
                    f"(prefix with '+' to add new keys)"
                )
            node[k] = Config()
        node = node[k]
    if not create and keys[-1] not in node:
        raise KeyError(
            f"Override key '{dotted}' not found in config (prefix with '+' to add)"
        )
    node[keys[-1]] = _wrap(value)


def _del_dotted(cfg: dict, dotted: str) -> None:
    keys = dotted.split(".")
    node = cfg
    for k in keys[:-1]:
        node = node[k]
    node.pop(keys[-1], None)


def _load_group_option(config_path: str, group: str, choice: Any) -> Any:
    """Load ``<config_path>/<group>/<choice>.yaml``; None means a null group."""
    if choice is None:
        return None
    path = os.path.join(config_path, *group.split("/"), f"{choice}.yaml")
    if not os.path.exists(path):
        avail_dir = os.path.join(config_path, *group.split("/"))
        avail: Iterable[str] = []
        if os.path.isdir(avail_dir):
            avail = sorted(
                [f[:-5] for f in os.listdir(avail_dir) if f.endswith(".yaml")]
                + [f"{d}/" for d in os.listdir(avail_dir)
                   if os.path.isdir(os.path.join(avail_dir, d))]
            )
        raise FileNotFoundError(
            f"Config group '{group}' has no option '{choice}'. "
            f"Available: {list(avail)}"
        )
    return load_yaml(path)


def compose(
    config_path: str,
    config_name: str,
    overrides: Iterable[str] = (),
) -> Config:
    """Hydra-style composition.

    The root config's ``defaults:`` list entries are processed in order:
      * ``_self_``             — the root config's own keys merge at this point
      * ``{group: choice}``    — load ``group/choice.yaml`` under key ``group``;
                                 ``choice`` may be overridden via ``group=other``;
                                 ``null`` skips the group; ``'??'`` is mandatory.
    Overrides after composition:
      * ``group=choice``       — picks a group option (if ``group`` is a defaults
                                 group), else sets a scalar root key
      * ``a.b.c=value``        — sets a nested key (must exist)
      * ``+a.b=value``         — adds a new nested key
      * ``~a.b``               — deletes a key
    """
    root = load_yaml(os.path.join(config_path, f"{config_name}.yaml"))
    defaults = root.pop("defaults", [])

    # split overrides into group-choices vs dotted key sets
    group_names = []
    for entry in defaults:
        if isinstance(entry, dict):
            group_names.extend(entry.keys())
    group_choices: dict[str, Any] = {}
    kv_overrides: list[tuple[str, str]] = []
    for ov in overrides:
        if ov.startswith("~"):
            kv_overrides.append(("~", ov[1:]))
            continue
        if "=" not in ov:
            raise ValueError(f"Malformed override '{ov}' (expected key=value)")
        key, val = ov.split("=", 1)
        add = key.startswith("+")
        key = key.lstrip("+")
        if not add and key in group_names and "." not in key:
            group_choices[key] = _parse_value(val)
        else:
            kv_overrides.append(("+" if add else "=", f"{key}={val}"))

    cfg = Config()
    self_merged = False
    for entry in defaults:
        if entry == "_self_":
            _deep_merge(cfg, root)
            self_merged = True
            continue
        if not isinstance(entry, dict):
            raise ValueError(f"Unsupported defaults entry: {entry!r}")
        for group, choice in entry.items():
            if group in group_choices:
                choice = group_choices.pop(group)
            if choice == _MISSING:
                raise MissingMandatoryValue(
                    f"Config group '{group}' is mandatory; pass {group}=<option>"
                )
            loaded = _load_group_option(config_path, group, choice)
            cfg[group] = loaded
    if not self_merged:
        _deep_merge(cfg, root)
    if group_choices:
        raise ValueError(f"Unknown config groups in overrides: {list(group_choices)}")

    for op, item in kv_overrides:
        if op == "~":
            _del_dotted(cfg, item)
        else:
            key, val = item.split("=", 1)
            _set_dotted(cfg, key, _parse_value(val), create=(op == "+"))
    return cfg


def resolve_target(target: str) -> str:
    """The port's dotted path for a config ``_target_``."""
    if target in TARGETS:
        return TARGETS[target]
    raise NotImplementedError(
        f"config target {target!r} has no port in bergen_tpu_torch yet "
        "(see ROADMAP.md Queue 1); ported targets: "
        f"{sorted(TARGETS)}")


def _locate(target: str) -> Any:
    """Import ``pkg.mod.Class`` (dotted path) and return the attribute."""
    parts = target.split(".")
    for split in range(len(parts) - 1, 0, -1):
        mod_name = ".".join(parts[:split])
        try:
            obj = importlib.import_module(mod_name)
        except ModuleNotFoundError:
            continue
        try:
            for attr in parts[split:]:
                obj = getattr(obj, attr)
            return obj
        except AttributeError:
            continue
    raise ImportError(f"Cannot locate target '{target}'")


def instantiate(node: Any, **kwargs: Any):
    """Construct the object described by a ``_target_`` node (reference:
    ``hydra.utils.instantiate`` calls at ``modules/rag.py:188``,
    ``modules/retrieve.py:34``). Nested ``_target_`` dicts are instantiated
    recursively; ``kwargs`` override node keys."""
    if node is None:
        return None
    if not isinstance(node, dict):
        return node
    params = {k: v for k, v in node.items() if k != "_target_"}
    params.update(kwargs)
    built = {}
    for k, v in params.items():
        if isinstance(v, dict) and "_target_" in v:
            built[k] = instantiate(v)
        else:
            built[k] = v
    if "_target_" not in node:
        return Config(built)
    cls = _locate(resolve_target(node["_target_"]))
    return cls(**built)

