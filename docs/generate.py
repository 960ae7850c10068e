"""Generate Markdown API reference from the package docstrings.

The reference ships Sphinx/numpydoc HTML documentation
(/root/reference/sphinx-documentation-generator, README.md:98-111); this
project keeps the docs toolchain dependency-free: every public module,
class and function docstring is rendered to ``docs/api/<module>.md``.

Usage: python docs/generate.py
"""

import importlib
import inspect
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

OUT = pathlib.Path(__file__).parent / "api"

MODULES = [
    "simplestereo_jax",
    "simplestereo_jax.rigs",
    "simplestereo_jax.calibration",
    "simplestereo_jax.calibration.chessboard",
    "simplestereo_jax.calibration.ba",
    "simplestereo_jax.calibration.procam",
    "simplestereo_jax.calibration.sharded",
    "simplestereo_jax.rectification",
    "simplestereo_jax.warp",
    "simplestereo_jax.passive",
    "simplestereo_jax.passive.asw",
    "simplestereo_jax.passive.asw_pallas",
    "simplestereo_jax.passive.asw_ref",
    "simplestereo_jax.passive.sgm",
    "simplestereo_jax.passive.gsw",
    "simplestereo_jax.passive.postfilter",
    "simplestereo_jax.passive.wls",
    "simplestereo_jax.passive.lab",
    "simplestereo_jax.active",
    "simplestereo_jax.active.patterns",
    "simplestereo_jax.active.graycode",
    "simplestereo_jax.active.ftp",
    "simplestereo_jax.active.stripe",
    "simplestereo_jax.unwrapping",
    "simplestereo_jax.points",
    "simplestereo_jax.parallel",
    "simplestereo_jax.parallel.sgm",
    "simplestereo_jax.parallel.gsw",
    "simplestereo_jax.parallel.ftp",
    "simplestereo_jax.v4l2",
    "simplestereo_jax.profiling",
    "simplestereo_jax.evaluation",
    "simplestereo_jax.geometry.projection",
    "simplestereo_jax.geometry.distortion",
    "simplestereo_jax.geometry.npgeom",
    "simplestereo_jax.geometry.rotations",
    "simplestereo_jax.utils",
    "simplestereo_jax.imgio",
]


def _doc(obj):
    d = inspect.getdoc(obj)
    return d.strip() if d else ""


def _sig(obj):
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = getattr(mod, n, None)
        if obj is None or inspect.ismodule(obj):
            continue
        if (inspect.isclass(obj) or inspect.isfunction(obj)
                or callable(obj)):
            home = getattr(obj, "__module__", mod.__name__)
            if home and not home.startswith("simplestereo_jax"):
                continue
            out.append((n, obj))
    return out


def render_module(name):
    mod = importlib.import_module(name)
    lines = [f"# `{name}`", ""]
    if _doc(mod):
        lines += [_doc(mod), ""]
    for n, obj in _public_members(mod):
        if inspect.isclass(obj):
            lines += [f"## class `{n}{_sig(obj)}`", ""]
            if _doc(obj):
                lines += [_doc(obj), ""]
            for mn, m in inspect.getmembers(obj, inspect.isfunction):
                if mn.startswith("_") and mn != "__init__":
                    continue
                if mn == "__init__":
                    continue
                if m.__qualname__.split(".")[0] != obj.__name__:
                    continue  # inherited
                lines += [f"### `{n}.{mn}{_sig(m)}`", ""]
                if _doc(m):
                    lines += [_doc(m), ""]
        else:
            lines += [f"## `{n}{_sig(obj)}`", ""]
            if _doc(obj):
                lines += [_doc(obj), ""]
    return "\n".join(lines) + "\n"


HTML_OUT = pathlib.Path(__file__).parent / "html"

_CSS = """
body { font-family: -apple-system, "Segoe UI", Roboto, sans-serif;
       max-width: 56rem; margin: 2rem auto; padding: 0 1rem;
       color: #1a1a1a; line-height: 1.55; }
h1, h2, h3 { line-height: 1.25; }
h2 { border-bottom: 1px solid #ddd; padding-bottom: .2rem; }
code { background: #f3f4f6; padding: .1rem .3rem; border-radius: 4px;
       font-size: .92em; }
pre code { display: block; padding: .8rem; overflow-x: auto; }
a { color: #0b5fff; text-decoration: none; }
a:hover { text-decoration: underline; }
"""


def _esc(s):
    return (s.replace("&", "&amp;").replace("<", "&lt;")
            .replace(">", "&gt;"))


def _inline(s):
    """Inline markdown: code spans then links (HTML-escaped elsewhere)."""
    import re
    s = _esc(s)
    s = re.sub(r"``([^`]+)``", r"<code>\1</code>", s)
    s = re.sub(r"`([^`]+)`", r"<code>\1</code>", s)
    s = re.sub(r"\[([^\]]+)\]\(([^)]+\.md)\)",
               lambda m: f'<a href="{m.group(2)[:-3]}.html">{m.group(1)}</a>',
               s)
    s = re.sub(r"\[([^\]]+)\]\(([^)]+)\)", r'<a href="\2">\1</a>', s)
    return s


def md_to_html(md, title):
    """Tiny dependency-free Markdown renderer (headers, fenced code,
    lists, paragraphs) — enough for the generated API pages, mirroring
    the reference's shipped Sphinx HTML (README.md:98-111) without a
    docs toolchain."""
    out = []
    in_code = in_list = False
    para = []

    def flush_para():
        nonlocal para
        if para:
            out.append("<p>" + _inline(" ".join(para)) + "</p>")
            para = []

    for ln in md.splitlines():
        if ln.startswith("```"):
            flush_para()
            out.append("<pre><code>" if not in_code else "</code></pre>")
            in_code = not in_code
            continue
        if in_code:
            out.append(_esc(ln))
            continue
        if ln.startswith("- "):
            flush_para()
            if not in_list:
                out.append("<ul>")
                in_list = True
            out.append("<li>" + _inline(ln[2:]) + "</li>")
            continue
        if in_list and not ln.startswith("- "):
            out.append("</ul>")
            in_list = False
        if ln.startswith("#"):
            flush_para()
            lvl = len(ln) - len(ln.lstrip("#"))
            out.append(f"<h{lvl}>{_inline(ln[lvl:].strip())}</h{lvl}>")
        elif not ln.strip():
            flush_para()
        else:
            para.append(ln.strip())
    flush_para()
    if in_list:
        out.append("</ul>")
    body = "\n".join(out)
    return (f"<!DOCTYPE html><html><head><meta charset='utf-8'>"
            f"<title>{_esc(title)}</title><style>{_CSS}</style></head>"
            f"<body>{body}</body></html>\n")


def main():
    OUT.mkdir(parents=True, exist_ok=True)
    HTML_OUT.mkdir(parents=True, exist_ok=True)
    index = ["# simplestereo_jax API reference", ""]
    for name in MODULES:
        try:
            text = render_module(name)
        except Exception as e:  # pragma: no cover
            print(f"skip {name}: {e}", file=sys.stderr)
            continue
        fn = name.replace(".", "_") + ".md"
        (OUT / fn).write_text(text)
        (HTML_OUT / (fn[:-3] + ".html")).write_text(md_to_html(text, name))
        mod = importlib.import_module(name)
        summary = ""
        short = name.rsplit(".", 1)[-1]
        for ln in _doc(mod).splitlines():
            ln = ln.strip()
            if ln and ln != short and not set(ln) <= {"=", "-"}:
                summary = ln
                break
        index.append(f"- [`{name}`]({fn}) — {summary}")
    (OUT / "index.md").write_text("\n".join(index) + "\n")
    (HTML_OUT / "index.html").write_text(
        md_to_html("\n".join(index) + "\n", "simplestereo_jax API"))
    print(f"wrote {len(MODULES)} module pages to {OUT} and {HTML_OUT}")


if __name__ == "__main__":
    main()
