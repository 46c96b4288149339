"""Every option that an mve_tpu app parses also parses in the port's app.

For each app, mve_tpu's parser is read from its main(); then, for every
option string of it (each alias, and each subcommand's options), one
command line goes through both packages' main(). The work is stubbed:
ArgumentParser.parse_args raises right after it returns, so no app runs.
Both namespaces must be equal, but for the port's --device, which is the
only option the port may add.
"""

import argparse
import importlib

import pytest
import torch

torch.set_num_threads(1)

APPS = ("sfmrecon", "dmrecon", "scene2pset", "fssrecon", "meshclean", "makescene",
        "prebundle", "featurerecon", "bundle2pset", "mesh2pset", "meshconvert",
        "meshalign", "sceneupgrade", "sceneinspect", "meshview")
PORT_ONLY = {"--device"}


class _Parsed(Exception):
    def __init__(self, parser, namespace):
        super().__init__()
        self.parser, self.namespace = parser, namespace


def parse(main, argv, monkeypatch):
    """(parser, namespace) of main(argv), stopped right after parsing."""
    real = argparse.ArgumentParser.parse_args

    def stop(self, args=None, namespace=None):
        raise _Parsed(self, real(self, args, namespace))

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", stop)
        with pytest.raises(_Parsed) as info:
            main(argv)
    return info.value.parser, info.value.namespace


def _value(action):
    """One value per argument the option takes (nargs=3 takes three)."""
    n = action.nargs if isinstance(action.nargs, int) else 1
    if action.choices:
        return [str(next(iter(action.choices)))] * n
    if action.type is int:
        return ["3"] * n
    if action.type is float:
        return ["0.5"] * n
    return ["v"] * n


def _positionals(parser):
    argv = []
    for a in parser._actions:
        if a.option_strings or isinstance(a, argparse._SubParsersAction):
            continue
        if a.nargs in ("+", argparse.REMAINDER):
            argv += ["p0", "p1"]
        elif a.nargs not in ("?", "*"):
            argv += ["p"] * (a.nargs if isinstance(a.nargs, int) else 1)
    return argv


def _option_argvs(parser):
    """(option string, argv fragment) for every option string of parser;
    the required options come with every fragment."""
    required = []
    for a in parser._actions:
        if a.option_strings and a.required:
            required += [a.option_strings[0]] + _value(a)
    out = []
    for a in parser._actions:
        if not a.option_strings or isinstance(a, argparse._HelpAction):
            continue
        takes_value = a.nargs != 0 and not (a.nargs == "?" and a.const is not None)
        for opt in a.option_strings:
            frag = [opt] + (_value(a) if takes_value else [])
            if not a.required:
                frag = required + frag
            out.append((opt, frag))
    out.append(("(defaults)", list(required)))
    return out


def command_lines(parser):
    """(label, argv) covering every option string of parser and of each of
    its subcommands."""
    subs = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    if not subs:
        pos = _positionals(parser)
        return [(opt, pos + frag) for opt, frag in _option_argvs(parser)]
    lines = []
    for name, sp in subs[0].choices.items():
        pos = _positionals(sp)
        lines += [(f"{name} {opt}", [name] + pos + frag) for opt, frag in _option_argvs(sp)]
    return lines


def option_strings(parser):
    opts = set()
    for a in parser._actions:
        opts.update(a.option_strings)
        if isinstance(a, argparse._SubParsersAction):
            for name, sp in a.choices.items():
                opts.update(f"{name} {o}" for o in option_strings(sp))
    return opts


@pytest.mark.parametrize("app", APPS)
def test_every_reference_option_parses_in_the_port(app, monkeypatch):
    jmain = importlib.import_module(f"mve_tpu.apps.{app}").main
    seen = {}

    def capture(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed(self, None)

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", capture)
        with pytest.raises(_Parsed):
            jmain([])
    jparser = seen["parser"]
    pmain = importlib.import_module(f"mve_tpu_torch.apps.{app}").main

    lines = command_lines(jparser)
    assert lines
    for label, argv in lines:
        _, want = parse(jmain, argv, monkeypatch)
        pparser, got = parse(pmain, argv, monkeypatch)
        got = vars(got)
        for extra in PORT_ONLY:
            got.pop(extra.lstrip("-").replace("-", "_"), None)
        assert got == vars(want), f"{app} {label}: {argv}"
    extra = {o.split()[-1] for o in option_strings(pparser) - option_strings(jparser)}
    assert extra <= PORT_ONLY, f"{app}: the port adds {sorted(extra)}"
