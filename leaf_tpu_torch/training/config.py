"""Experiment configs: the ``.cfg`` YAML files of ``cfgs/``.

``leaf_tpu.training.config``'s schema: five sections (frontend / model /
opt / audio_config / data), the same compulsory keys, the same injected
optional defaults, manifest paths resolved against ``meta_root``, and the
contrastive-type ``proj_out_dim`` assertion.

The JAX package reads the files with PyYAML's ``FullLoader``; the port
reads them with a reader of its own (``parse_config``), which gives the
same values of the same types for the subset of YAML the configs use:

- a mapping of sections, each a mapping of scalars (two levels), with
  comments and blank lines;
- plain, single-quoted and double-quoted scalars;
- YAML 1.1 resolution of plain scalars, as PyYAML's resolver does it:
  ``1e-3`` has no dot and stays the *string* ``'1e-3'``, ``1.0e-3`` is a
  float, ``None`` is the string ``'None'`` (``null``, ``~`` and an empty
  value are None), ``True``/``yes``/``off`` are booleans, ``0x1f`` and
  ``017`` are ints.

Anything else (sequences, flow collections, anchors, tags, block
scalars, multi-line scalars, documents, tabs, sexagesimal numbers and
timestamps) raises ``ValueError`` with the line: the reader never guesses.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["get_config", "parse_config", "parse_config_text",
           "get_data_info", "check_and_fill_optional_arguments"]


__compulsory_keys__ = {
    "frontend": ["name"],
    "model": ["arch", "type"],
    "opt": ["optimizer", "lr", "batch_size"],
    "audio_config": ["feature", "normalize", "sample_rate", "min_duration"],
    "data": ["meta_root", "is_lmdb", "label_map"],
}

__optional_arguments__ = {
    "frontend": {"default_args": False},
    "model": {"activation": "relu"},
    "opt": {
        "scheduler": "step",
        "agc_clip_factor": 0.01,
        "weight_decay": 0.0,
        "agc_clipping": True,
        "gamma": 0.1,
        "patience": 15,
        "step_size": 30,
        "warmup_epochs": 15,
    },
    "audio_config": {
        "random_clip_size": 2.5,
        "val_clip_size": 2.5,
        "mixup": False,
    },
    "data": {"background_noise_dir": None},
}


def get_data_info(cfg: Dict, augment: Optional[bool] = True) -> Dict:
    """Resolve manifest/label-map paths against meta_root
    (reference: config_parser.py:6-52)."""
    meta_root = cfg["meta_root"]
    label_map = cfg["label_map"]
    is_lmdb = cfg.get("is_lmdb", False)
    if not is_lmdb:
        train_manifest = os.path.join(meta_root, cfg["train_manifest"])
        val_manifest = os.path.join(meta_root, cfg["val_manifest"])
        label_map = os.path.join(meta_root, label_map)
        results = {
            "train": train_manifest,
            "val": val_manifest,
            "labels": label_map,
            "in_memory": cfg.get("in_memory", False),
        }
        test_manifest = cfg.get("test_manifest", None)
        if test_manifest and test_manifest != "None":
            results["test"] = os.path.join(meta_root, test_manifest)
        results["bg_files"] = cfg.get("bg_files", None)
        results["background_noise_dir"] = cfg.get("background_noise_dir", None)
    else:
        # the JAX package maps "lmdb" configs onto its packed-shard dataset
        label_map = (os.path.join(meta_root, label_map)
                     if not os.path.exists(label_map) else label_map)
        results = {
            "train": cfg["train_lmdb"],
            "val": cfg["val_lmdb"],
            "labels": label_map,
            "is_lmdb": True,
        }
        test = cfg.get("test_lmdb", None)
        if test and test != "None":
            results["test_lmdb"] = test
        results["background_noise_dir"] = cfg.get("background_noise_dir", None)
    return results


def check_and_fill_optional_arguments(cfg: Dict) -> Dict:
    for k in __compulsory_keys__:
        if k not in cfg:
            raise KeyError(f"config missing required section '{k}'")
    for k, v in cfg.items():
        if k not in __compulsory_keys__:
            raise KeyError(f"unknown config section '{k}'")
        for rkey in __compulsory_keys__[k]:
            if rkey not in v:
                raise KeyError(f"{rkey} not found in section '{k}'")
        for optk, optv in __optional_arguments__[k].items():
            v.setdefault(optk, optv)
    if cfg["model"]["type"] == "contrastive":
        assert "proj_out_dim" in cfg["model"], \
            "contrastive model type requires model.proj_out_dim"
    return cfg


# ------------------------------------------------------------- YAML subset

# PyYAML's implicit resolvers (yaml/resolver.py), YAML 1.1
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on",
                          "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off",
                          "Off", "OFF"), False)}
_NULL = {"", "~", "null", "Null", "NULL"}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
# resolved by PyYAML to kinds outside the subset: sexagesimal ints and
# floats, timestamps, the merge key and the value key
_UNSUPPORTED = re.compile(r"""^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
                    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.*
                    |<<|=)$""", re.X)
_KEY = re.compile(r"^[A-Za-z_][A-Za-z0-9_.-]*$")
# characters that may not start a plain scalar (YAML 1.1 indicators)
_INDICATORS = set("[]{},#&*!|>'\"%@`")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line:
    def __init__(self, path: str, number: int, text: str):
        self.where = f"{path}:{number}"
        self.text = text

    def error(self, what: str) -> ValueError:
        return ValueError(f"{self.where}: {what} is outside the YAML subset "
                          f"the config reader takes: {self.text.strip()!r}")


def _resolve_plain(text: str, line: _Line) -> Any:
    if _UNSUPPORTED.match(text):
        raise line.error(f"the plain scalar {text!r}")
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.match(text):
        digits = text.replace("_", "")
        sign = -1 if digits[0] == "-" else 1
        digits = digits.lstrip("+-")
        if digits == "0":
            return 0
        if digits.startswith("0b"):
            return sign * int(digits[2:], 2)
        if digits.startswith("0x"):
            return sign * int(digits[2:], 16)
        if digits.startswith("0"):
            return sign * int(digits, 8)
        return sign * int(digits)
    if _FLOAT.match(text):
        value = text.replace("_", "").lower()
        if value.endswith(".inf"):
            return float("-inf") if value[0] == "-" else float("inf")
        if value.endswith(".nan"):
            return float("nan")
        return float(value)
    return text


def _double_quoted(body: str, line: _Line) -> str:
    out, i = [], 0
    while i < len(body):
        c = body[i]
        if c != "\\":
            out.append(c)
            i += 1
            continue
        e = body[i + 1] if i + 1 < len(body) else ""
        if e in _ESCAPES:
            out.append(_ESCAPES[e])
            i += 2
        elif e in _HEX_ESCAPES:
            n = _HEX_ESCAPES[e]
            code = body[i + 2:i + 2 + n]
            if len(code) != n or not re.fullmatch(r"[0-9A-Fa-f]+", code):
                raise line.error(f"the escape \\{e}{code}")
            out.append(chr(int(code, 16)))
            i += 2 + n
        else:
            raise line.error(f"the escape \\{e}")
    return "".join(out)


def _after_quote(rest: str, line: _Line) -> None:
    """Only blanks and a comment may follow a quoted scalar."""
    rest = rest.strip(" ")
    if rest and not rest.startswith("#"):
        raise line.error("text after a quoted scalar")


def _scalar(text: str, line: _Line) -> Any:
    """One scalar value (the text after ``key:``, comment included)."""
    text = text.strip(" ")
    if not text or text.startswith("#"):
        return None
    if text[0] == '"':
        m = re.match(r'"((?:[^"\\]|\\.)*)"', text)
        if not m:
            raise line.error("an unterminated double-quoted scalar")
        _after_quote(text[m.end():], line)
        return _double_quoted(m.group(1), line)
    if text[0] == "'":
        m = re.match(r"'((?:[^']|'')*)'", text)
        if not m:
            raise line.error("an unterminated single-quoted scalar")
        _after_quote(text[m.end():], line)
        return m.group(1).replace("''", "'")
    # a plain scalar ends at " #"; it may hold no ": " and not end in ":"
    m = re.search(r"\s#", text)
    plain = (text[:m.start()] if m else text).rstrip(" ")
    if (plain[0] in _INDICATORS or plain[0] in "-?:" and
            (len(plain) == 1 or plain[1] == " ")):
        raise line.error(f"the indicator {plain[0]!r}")
    if ": " in plain or plain.endswith(":") or "\t" in plain:
        raise line.error("a nested mapping in a value")
    return _resolve_plain(plain, line)


def _key_value(text: str, line: _Line) -> Tuple[str, Optional[str]]:
    """``key: value`` → (key, value text); ``key:`` → (key, None)."""
    m = re.match(r"^([^\s:#'\"]+):(?:\s+(.*))?$", text)
    if not m or not _KEY.match(m.group(1)):
        raise line.error("a line that is not 'key: value'")
    if not isinstance(_resolve_plain(m.group(1), line), str):
        raise line.error(f"the key {m.group(1)!r}, which is not a string")
    value = m.group(2)
    if value is not None and (not value.strip(" ") or
                              value.strip(" ").startswith("#")):
        value = None
    return m.group(1), value


def parse_config_text(text: str, path: str = "<string>") -> Dict:
    """Read a config's YAML text (the subset of the module docstring)."""
    cfg: Dict[str, Any] = {}
    section: Optional[str] = None
    indent: Optional[int] = None
    lines: List[_Line] = [_Line(path, i + 1, t)
                          for i, t in enumerate(text.splitlines())]
    for line in lines:
        raw = line.text
        stripped = raw.strip(" ")
        if not stripped or stripped.startswith("#"):
            continue
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise line.error("a tab in the indentation")
        if stripped in ("---", "...") or stripped.startswith(("--- ", "%")):
            raise line.error("a document marker or directive")
        depth = len(raw) - len(raw.lstrip(" "))
        key, value = _key_value(stripped, line)
        if depth == 0:
            section, indent = None, None
            if value is None:
                # a section; it stays None (as in YAML) if nothing follows
                cfg[key] = None
                section = key
            else:
                cfg[key] = _scalar(value, line)
            continue
        if section is None:
            raise line.error("an indented line outside a section")
        if indent is None:
            indent = depth
            cfg[section] = {}
        elif depth != indent:
            raise line.error("a third level or an uneven indentation")
        if value is None:
            # 'key:' with nothing after it is null; a deeper block would
            # be a third level, which the next line's indentation rejects
            cfg[section][key] = None
        else:
            cfg[section][key] = _scalar(value, line)
    return cfg


def parse_config(config_file: str) -> Dict:
    with open(config_file, "r") as fd:
        return parse_config_text(fd.read(), config_file)


def get_config(config_file: str) -> Dict:
    cfg = parse_config(config_file)
    check_and_fill_optional_arguments(cfg)
    cfg["data"] = get_data_info(cfg["data"])
    return cfg
