"""OpenMetrics text exposition: render a :class:`~.registry.MetricsRegistry`
to scrape text, and parse it back strictly.

The renderer targets the OpenMetrics 1.0 text format (the strict subset of
the Prometheus exposition format that vLLM, Ray, and every modern scraper
speak): ``# TYPE``/``# HELP`` metadata lines per family, ``_total``-suffixed
counter samples, cumulative ``le``-bucketed histograms with a ``+Inf``
bucket equal to ``_count``, label values escaped (``\\``, ``\"``, ``\n``),
and a terminating ``# EOF``.

The parser is deliberately *strict* — it exists so the test suite and the
smoke benchmark can prove the rendered text round-trips: unknown sample
suffixes, counters without ``_total``, non-monotonic histogram buckets, a
missing ``+Inf`` bucket, bad escapes, or a missing ``# EOF`` all raise
:class:`ValueError` instead of being silently tolerated.
"""

from __future__ import annotations

import math

__all__ = ["render_openmetrics", "parse_openmetrics", "CONTENT_TYPE"]

#: the content type scrapers negotiate for this format
CONTENT_TYPE = "application/openmetrics-text; version=1.0.0; charset=utf-8"


def _escape_label_value(value: str) -> str:
    return value.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(value: str) -> str:
    return value.replace("\\", "\\\\").replace("\n", "\\n")


def _format_value(value: float) -> str:
    if value == math.inf:
        return "+Inf"
    f = float(value)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _labels_text(labels: tuple, extra: tuple = ()) -> str:
    pairs = list(labels) + list(extra)
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{_escape_label_value(str(v))}"' for k, v in pairs)
    return "{" + inner + "}"


def _exemplar_text(exemplar: tuple) -> str:
    """OpenMetrics 1.0 exemplar suffix: `` # {labels} value ts`` — the
    braces are mandatory (unlike a sample's label set) even when empty."""
    labels, value, ts = exemplar
    inner = ",".join(
        f'{k}="{_escape_label_value(str(v))}"' for k, v in labels
    )
    text = f" # {{{inner}}} {_format_value(value)}"
    if ts is not None:
        text += f" {repr(float(ts))}"
    return text


def render_openmetrics(registry) -> str:
    """One scrape's worth of exposition text for every family in
    ``registry`` (insertion-ordered, samples label-sorted for determinism)."""
    lines: list[str] = []
    for metric in registry.collect():
        lines.append(f"# TYPE {metric.name} {metric.kind}")
        if metric.help:
            lines.append(f"# HELP {metric.name} {_escape_help(metric.help)}")
        for series in sorted(metric.series(), key=lambda s: s.labels):
            if metric.kind == "counter":
                lines.append(
                    f"{metric.name}_total{_labels_text(series.labels)} "
                    f"{_format_value(series.value)}"
                )
            elif metric.kind == "gauge":
                lines.append(
                    f"{metric.name}{_labels_text(series.labels)} "
                    f"{_format_value(series.value)}"
                )
            else:  # histogram: cumulative le buckets + +Inf + sum/count
                cum = 0
                exemplars = getattr(series, "exemplars", None) or {}
                for i, (bound, raw) in enumerate(
                    zip(metric.buckets, series.bucket_counts)
                ):
                    cum += raw
                    line = (
                        f"{metric.name}_bucket"
                        f"{_labels_text(series.labels, (('le', _format_value(bound)),))} "
                        f"{cum}"
                    )
                    if i in exemplars:
                        line += _exemplar_text(exemplars[i])
                    lines.append(line)
                line = (
                    f"{metric.name}_bucket"
                    f"{_labels_text(series.labels, (('le', '+Inf'),))} "
                    f"{series.count}"
                )
                if len(metric.buckets) in exemplars:
                    line += _exemplar_text(exemplars[len(metric.buckets)])
                lines.append(line)
                lines.append(
                    f"{metric.name}_count{_labels_text(series.labels)} {series.count}"
                )
                lines.append(
                    f"{metric.name}_sum{_labels_text(series.labels)} "
                    f"{_format_value(series.total)}"
                )
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


# ---------------------------------------------------------------------------
# strict parser (the round-trip proof the tests and metrics-smoke rely on)
# ---------------------------------------------------------------------------

_SUFFIXES = {
    "counter": ("_total",),
    "histogram": ("_bucket", "_count", "_sum"),
    "gauge": ("",),
}


def _parse_labels(text: str, line: str) -> dict[str, str]:
    """Parse ``name="value",...`` with escape handling; raises on any
    malformation (unterminated string, bad escape, junk between pairs)."""
    labels: dict[str, str] = {}
    i = 0
    n = len(text)
    while i < n:
        j = i
        while j < n and (text[j].isalnum() or text[j] == "_"):
            j += 1
        name = text[i:j]
        if not name or j >= n or text[j] != "=":
            raise ValueError(f"bad label name in: {line}")
        j += 1
        if j >= n or text[j] != '"':
            raise ValueError(f"label value must be quoted in: {line}")
        j += 1
        out = []
        while j < n and text[j] != '"':
            ch = text[j]
            if ch == "\\":
                j += 1
                if j >= n:
                    raise ValueError(f"dangling escape in: {line}")
                esc = text[j]
                if esc == "n":
                    out.append("\n")
                elif esc in ('"', "\\"):
                    out.append(esc)
                else:
                    raise ValueError(f"bad escape \\{esc} in: {line}")
            else:
                out.append(ch)
            j += 1
        if j >= n:
            raise ValueError(f"unterminated label value in: {line}")
        labels[name] = "".join(out)
        j += 1  # closing quote
        if j < n:
            if text[j] != ",":
                raise ValueError(f"junk after label value in: {line}")
            j += 1
        i = j
    return labels


def _parse_value(text: str, line: str) -> float:
    if text == "+Inf":
        return math.inf
    if text == "-Inf":
        return -math.inf
    try:
        return float(text)
    except ValueError:
        raise ValueError(f"bad sample value {text!r} in: {line}") from None


def _parse_exemplar(text: str, line: str) -> dict:
    """Parse the OpenMetrics exemplar tail ``{labels} value [ts]`` (the
    part after ``# ``), strictly: mandatory braces, escape-aware labelset,
    the spec's 128-char labelset cap."""
    text = text.strip()
    if not text.startswith("{"):
        raise ValueError(f"exemplar must start with a labelset in: {line}")
    i = _find_close_brace(text, 0)
    if i < 0:
        raise ValueError(f"unterminated exemplar labelset in: {line}")
    labels = _parse_labels(text[1:i], line)
    if sum(len(k) + len(v) for k, v in labels.items()) > 128:
        raise ValueError(f"exemplar labelset exceeds 128 characters in: {line}")
    rest = text[i + 1 :].split()
    if not rest or len(rest) > 2:
        raise ValueError(
            f"exemplar needs a value (and at most a timestamp) in: {line}"
        )
    value = _parse_value(rest[0], line)
    ts = _parse_value(rest[1], line) if len(rest) == 2 else None
    return {"labels": labels, "value": value, "ts": ts}


def _find_close_brace(text: str, start: int) -> int:
    """Index of the ``}`` closing the labelset opened at ``start``,
    respecting quoted values and escapes; -1 when unterminated."""
    i, n, in_str, esc = start + 1, len(text), False, False
    while i < n:
        ch = text[i]
        if in_str:
            if esc:
                esc = False
            elif ch == "\\":
                esc = True
            elif ch == '"':
                in_str = False
        elif ch == '"':
            in_str = True
        elif ch == "}":
            return i
        i += 1
    return -1


def _split_sample(line: str) -> tuple[str, dict[str, str], float, dict | None]:
    brace = line.find("{")
    hash_pos = line.find("#")
    if brace >= 0 and (hash_pos < 0 or brace < hash_pos):
        close = _find_close_brace(line, brace)
        if close < 0:
            raise ValueError(f"unbalanced braces in: {line}")
        name = line[:brace]
        labels = _parse_labels(line[brace + 1 : close], line)
        rest = line[close + 1 :].strip()
    else:
        parts = line.split(None, 1)
        if len(parts) != 2:
            raise ValueError(f"sample line needs a value: {line}")
        name, rest = parts
        labels = {}
    if not rest:
        raise ValueError(f"sample line needs a value: {line}")
    parts = rest.split(None, 1)
    value = _parse_value(parts[0], line)
    exemplar = None
    if len(parts) == 2:
        tail = parts[1].strip()
        if tail.startswith("#"):
            exemplar = _parse_exemplar(tail[1:], line)
        else:
            # a timestamp after the value, optionally followed by the
            # exemplar — anything else is junk
            sub = tail.split(None, 1)
            _parse_value(sub[0], line)
            if len(sub) == 2:
                t2 = sub[1].strip()
                if not t2.startswith("#"):
                    raise ValueError(f"junk after sample timestamp in: {line}")
                exemplar = _parse_exemplar(t2[1:], line)
    return name, labels, value, exemplar


def _check_histogram(family: dict, name: str) -> None:
    """Bucket invariants per label-set: ``le`` values strictly ascending,
    cumulative counts non-decreasing, ``+Inf`` bucket present and equal to
    ``_count``, and ``_count``/``_sum`` present."""
    by_series: dict[tuple, list[tuple[float, float]]] = {}
    counts: dict[tuple, float] = {}
    sums: dict[tuple, float] = {}
    for sample_name, labels, value in family["samples"]:
        key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
        if sample_name.endswith("_bucket"):
            if "le" not in labels:
                raise ValueError(f"histogram {name} bucket sample without le label")
            by_series.setdefault(key, []).append(
                (_parse_value(labels["le"], f'le="{labels["le"]}"'), value)
            )
        elif sample_name.endswith("_count"):
            counts[key] = value
        elif sample_name.endswith("_sum"):
            sums[key] = value
    if not by_series:
        raise ValueError(f"histogram {name} has no bucket samples")
    for key, buckets in by_series.items():
        bounds = [b for b, _ in buckets]
        if bounds != sorted(bounds) or len(set(bounds)) != len(bounds):
            raise ValueError(f"histogram {name} le bounds not strictly ascending")
        values = [v for _, v in buckets]
        if any(b > a for a, b in zip(values[1:], values)):
            raise ValueError(f"histogram {name} bucket counts not monotonic")
        if bounds[-1] != math.inf:
            raise ValueError(f"histogram {name} missing +Inf bucket")
        if key not in counts or key not in sums:
            raise ValueError(f"histogram {name} missing _count/_sum")
        if values[-1] != counts[key]:
            raise ValueError(
                f"histogram {name} +Inf bucket {values[-1]} != _count {counts[key]}"
            )
    # bucket exemplars must sit INSIDE their bucket's value range — an
    # exemplar above its le bound links a scrape to the wrong trace
    for entry in family.get("exemplars", ()):
        if not entry["sample"].endswith("_bucket"):
            continue
        le_text = entry["labels"].get("le")
        if le_text is None:
            continue  # already rejected by the bucket-without-le check
        le = _parse_value(le_text, f'le="{le_text}"')
        key = tuple(
            sorted((k, v) for k, v in entry["labels"].items() if k != "le")
        )
        bounds = sorted(b for b, _ in by_series.get(key, ()))
        idx = bounds.index(le) if le in bounds else -1
        lower = bounds[idx - 1] if idx > 0 else -math.inf
        value = entry["exemplar"]["value"]
        if not (lower < value <= le):
            raise ValueError(
                f"histogram {name} exemplar value {value} outside its "
                f"bucket (le={le_text})"
            )


def parse_openmetrics(text: str) -> dict[str, dict]:
    """Strictly parse exposition text into
    ``{family_name: {"type", "help", "samples": [(name, labels, value)]}}``.

    Raises ValueError on anything outside the subset the renderer emits —
    that strictness is the point (see module doc)."""
    families: dict[str, dict] = {}
    current: str | None = None
    saw_eof = False
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            continue
        if saw_eof:
            raise ValueError("content after # EOF")
        if line == "# EOF":
            saw_eof = True
            continue
        if line.startswith("# TYPE "):
            parts = line.split()
            if len(parts) != 4:
                raise ValueError(f"malformed TYPE line: {line}")
            _, _, name, kind = parts
            if kind not in _SUFFIXES:
                raise ValueError(f"unknown metric type {kind!r}: {line}")
            if name in families:
                raise ValueError(f"duplicate TYPE for {name}")
            families[name] = {"type": kind, "help": "", "samples": [], "exemplars": []}
            current = name
            continue
        if line.startswith("# HELP "):
            parts = line.split(None, 3)
            if len(parts) < 3 or parts[2] != current:
                raise ValueError(f"HELP line outside its family: {line}")
            families[current]["help"] = parts[3] if len(parts) > 3 else ""
            continue
        if line.startswith("#"):
            raise ValueError(f"unknown comment line: {line}")
        name, labels, value, exemplar = _split_sample(line)
        family = None
        for fam_name, fam in families.items():
            for suffix in _SUFFIXES[fam["type"]]:
                if name == fam_name + suffix:
                    family = fam_name
                    break
            if family:
                break
        if family is None:
            raise ValueError(f"sample {name!r} matches no declared family")
        if families[family]["type"] == "counter" and not name.endswith("_total"):
            raise ValueError(f"counter sample must end in _total: {line}")
        if exemplar is not None:
            # the spec admits exemplars on histogram buckets and counter
            # totals only — a gauge (or _sum/_count) carrying one is junk
            if not (name.endswith("_bucket") or name.endswith("_total")):
                raise ValueError(
                    f"exemplar on a sample that cannot carry one: {line}"
                )
            families[family].setdefault("exemplars", []).append(
                {"sample": name, "labels": labels, "exemplar": exemplar}
            )
        families[family]["samples"].append((name, labels, value))
    if not saw_eof:
        raise ValueError("missing # EOF terminator")
    for name, family in families.items():
        if family["type"] == "histogram" and family["samples"]:
            _check_histogram(family, name)
    return families


def sample_value(families: dict, family: str, sample: str | None = None,
                 **labels) -> float | None:
    """Convenience for tests/smoke: the value of one sample (default: the
    family's bare/``_total`` sample) matching ``labels`` exactly."""
    fam = families.get(family)
    if fam is None:
        return None
    want = sample or (family + "_total" if fam["type"] == "counter" else family)
    for name, sample_labels, value in fam["samples"]:
        if name == want and sample_labels == {str(k): str(v) for k, v in labels.items()}:
            return value
    return None
