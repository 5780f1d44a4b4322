"""Experiment management (pvpuformer_tpu/utils/exp.py, itself
`isegm/utils/exp.py:16-186`): the config.yml cascade, numbered experiment
dirs, logging setup and config-as-code recipe loading.

  * `load_config_file` reads a config.yml with the port's own parser of the
    form those files are written in (no PyYAML: the card's machine is not
    known to have it, and one code path serves both machines);
  * `load_config(recipe)` walks from the recipe's directory up to the repo
    root collecting `config.yml` files (child overrides parent)
    (exp.py:152-186);
  * `init_experiment` creates `<EXPS_PATH>/<recipe-dir>/<recipe>/NNN[_suffix]/`
    with checkpoints/, vis/ and logs/, and snapshots the recipe
    (exp.py:34-67).
"""
from __future__ import annotations

import logging
import re
import shutil
import sys
from datetime import datetime
from pathlib import Path
from types import SimpleNamespace
from typing import Any, Dict, Optional

logger = logging.getLogger("pvpuformer_tpu_torch")


class EasyCfg(SimpleNamespace):
    """Attribute-dict like the reference's EasyDict usage."""

    def __getitem__(self, k):
        return getattr(self, k)

    def __setitem__(self, k, v):
        setattr(self, k, v)

    def __contains__(self, k):
        return hasattr(self, k)

    def get(self, k, default=None):
        return getattr(self, k, default)


# ---------------------------------------------------------------------------
# config.yml: `KEY: value` lines, `#` comments, one level of indented nested
# mapping; scalars typed as yaml.safe_load (YAML 1.1 resolvers) types them
# ---------------------------------------------------------------------------

_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*$")
_NULL = re.compile(r"(?:~|null|Null|NULL)?$")
_BOOL = {**dict.fromkeys("yes Yes YES true True TRUE on On ON".split(), True),
         **dict.fromkeys("no No NO false False FALSE off Off OFF".split(),
                         False)}
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"(?:[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9_]+(?:[eE][-+][0-9]+)?)$")
_INF_NAN = {**dict.fromkeys(["+.inf", "+.Inf", "+.INF", ".inf", ".Inf",
                             ".INF"], float("inf")),
            **dict.fromkeys(["-.inf", "-.Inf", "-.INF"], float("-inf")),
            **dict.fromkeys([".nan", ".NaN", ".NAN"], float("nan"))}
# plain scalars YAML 1.1 would type otherwise (binary, octal, hex and
# sexagesimal ints, sexagesimal floats, timestamps, merge and value keys):
# not in the form, so refused rather than read as strings
_OTHER = re.compile(r"[-+]?0b[0-1_]+$|[-+]?0[0-7_]+$|[-+]?0x[0-9a-fA-F_]+$"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?$"
                    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}|<<$|=$")
_INDICATORS = tuple("[]{}&*!|>%@`,") + ("- ", "? ", ": ")


class ConfigSyntaxError(ValueError):
    """A config file line outside the form `load_config_file` reads."""


def _scalar(text: str, where: str) -> Any:
    """One value, typed as yaml.safe_load types it."""
    if text[:1] in "'\"":
        q = text[0]
        if len(text) < 2 or not text.endswith(q):
            raise ConfigSyntaxError(f"{where}: unterminated quoted string")
        body = text[1:-1]
        if q == "'":
            if "'" in body.replace("''", ""):
                raise ConfigSyntaxError(f"{where}: stray quote in a string")
            return body.replace("''", "'")
        if "\\" in body or '"' in body:
            raise ConfigSyntaxError(f"{where}: escapes in double-quoted "
                                    f"strings are not read")
        return body
    if text.startswith(_INDICATORS) or text in ("-", "?") or ": " in text \
            or text.endswith(":") or "\t" in text or _OTHER.match(text):
        raise ConfigSyntaxError(f"{where}: value {text!r} is outside the "
                                f"form (plain scalars, quoted strings)")
    if _NULL.match(text):
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text):
        return float(text.replace("_", ""))
    if text in _INF_NAN:
        return _INF_NAN[text]
    return text


def _strip_comment(line: str) -> str:
    """The line without a `#` comment (one that starts the line or follows
    a space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or line[i - 1] in " :"):
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def parse_config(text: str, name: str = "<config>") -> Dict[str, Any]:
    """The mapping of a config file in `config.yml`'s form; raises
    ConfigSyntaxError naming the line on anything else."""
    out: Dict[str, Any] = {}
    block = indent = None           # the open `KEY:` line, its entries' indent
    for no, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{no}"
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ConfigSyntaxError(f"{where}: tab indentation")
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        lead = len(line) - len(line.lstrip(" "))
        key, sep, value = line.strip().partition(":")
        if not sep or (value and not value.startswith(" ")) \
                or not _KEY.match(key) or key in _BOOL or _NULL.match(key):
            raise ConfigSyntaxError(f"{where}: expected `KEY: value`, got "
                                    f"{line.strip()!r}")
        value = value.strip()
        if lead == 0:
            out[key] = _scalar(value, where) if value else None
            block, indent = (None if value else key), None
            continue
        if block is None:
            raise ConfigSyntaxError(f"{where}: indented line outside a "
                                    f"`KEY:` block")
        if indent is None:
            indent, out[block] = lead, {}
        if lead != indent or not value:
            raise ConfigSyntaxError(f"{where}: one level of nesting is read")
        out[block][key] = _scalar(value, where)
    return out


def load_config_file(config_path) -> Dict[str, Any]:
    """exp.py:177-186: the config mapping. A per-model `SUBCONFIGS` section
    nests two levels deep, outside the form, and raises."""
    path = Path(config_path)
    return parse_config(path.read_text(), str(path))


def load_config(model_path, repo_root=None) -> EasyCfg:
    """exp.py:152-174: cascade of config.yml from the model's dir upward."""
    model_path = Path(model_path).resolve()
    root = Path(repo_root).resolve() if repo_root else Path.cwd().resolve()

    cfg: Dict[str, Any] = {}
    cwd = model_path.parent
    chain = []
    while True:
        candidate = cwd / "config.yml"
        if candidate.exists():
            chain.append(candidate)
        if cwd == root or cwd == cwd.parent:
            break
        cwd = cwd.parent
    for path in reversed(chain):                 # parent first, child overrides
        cfg.update(load_config_file(path))
    return EasyCfg(**cfg)


def init_experiment(model_path, exps_path=None, exp_suffix: str = "",
                    resume_exp: Optional[str] = None,
                    repo_root=None, rank: int = 0) -> EasyCfg:
    """exp.py:16-67: returns cfg with EXP_PATH / CHECKPOINTS_PATH / VIS_PATH
    / LOGS_PATH set and the recipe snapshotted. A rank other than 0 of a
    process group joins the experiment rank 0 made (`resume_exp` names it)
    and logs to a file of its own."""
    model_path = Path(model_path).resolve()
    cfg = load_config(model_path, repo_root)
    if exps_path is None:
        exps_path = cfg.get("EXPS_PATH", "./experiments")

    rel = Path(model_path.parent.name) / model_path.stem
    exp_parent = Path(exps_path) / rel
    exp_parent.mkdir(parents=True, exist_ok=True)

    if resume_exp:
        candidates = sorted(exp_parent.glob(f"{resume_exp}*"))
        if not candidates:
            raise FileNotFoundError(f"no experiment matching {resume_exp!r} "
                                    f"under {exp_parent}")
        exp_path = candidates[0]
        logger.info("resuming experiment %s", exp_path)
    else:
        indices = [int(p.name.split("_")[0]) for p in exp_parent.iterdir()
                   if p.is_dir() and p.name.split("_")[0].isdigit()]
        index = max(indices, default=-1) + 1
        name = f"{index:03d}" + (f"_{exp_suffix}" if exp_suffix else "")
        exp_path = exp_parent / name
        exp_path.mkdir()

    cfg.EXP_PATH = exp_path
    cfg.CHECKPOINTS_PATH = exp_path / "checkpoints"
    cfg.VIS_PATH = exp_path / "vis"
    cfg.LOGS_PATH = exp_path / "logs"
    for p in (cfg.CHECKPOINTS_PATH, cfg.VIS_PATH, cfg.LOGS_PATH):
        p.mkdir(exist_ok=True)

    if not resume_exp:
        shutil.copy(model_path, exp_path / model_path.name)

    stamp = datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    add_logging(cfg.LOGS_PATH, prefix=f"train_{stamp}_"
                + (f"rank{rank}_" if rank else ""))
    return cfg


def add_logging(logs_path, prefix: str = "") -> None:
    """isegm/utils/log.py:12-27: a log file under `logs_path` and the
    console, for the port's logger."""
    Path(logs_path).mkdir(parents=True, exist_ok=True)
    stamp = datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    handler = logging.FileHandler(Path(logs_path) / f"{prefix}{stamp}.log")
    handler.setFormatter(logging.Formatter(
        "(%(levelname)s) %(asctime)s: %(message)s", "%Y-%m-%d %H:%M:%S"))
    logger.addHandler(handler)
    if not any(isinstance(h, logging.StreamHandler)
               and not isinstance(h, logging.FileHandler)
               for h in logger.handlers):
        sh = logging.StreamHandler(sys.stdout)
        sh.setFormatter(logging.Formatter("%(asctime)s %(message)s",
                                          "%H:%M:%S"))
        logger.addHandler(sh)
    logger.setLevel(logging.INFO)


def load_module(script_path):
    """train.py:97-102: import a config-as-code recipe."""
    import importlib.util
    spec = importlib.util.spec_from_file_location("model_script", script_path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
