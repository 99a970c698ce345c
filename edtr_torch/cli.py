"""Entry points of the port: the 30 ``main/{cls,seg,det}/*.py`` scripts.

    python -m edtr_torch.cli det train_edtr --config configs/det/voc2012/train/007_edtr-s4.yaml
    python -m edtr_torch.cli det test_edtr --save-img \
        --config configs/det/voc2012/test/007_edtr-s4.yaml

``{cls,seg,det} <script>`` names a JAX script (``main/det/train_edtr.py``
-> ``det train_edtr``); the rest of the command line is that script's own,
and the runner function it calls (``edtr_torch.train.runner``) gets the
same arguments as JAX's script gives JAX's. :data:`SCRIPTS` is the one
table of them: each script's runner function, fixed keyword arguments, its
flags beyond ``--config``, ``--debug`` and ``--seed`` and the seed's rule.
A flag a script lacks fails as in JAX (argparse exits 2). The runs go to
the card; there is no device flag.
"""

from __future__ import annotations

import argparse
import sys
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple


class Script(NamedTuple):
    """``fn``: the runner function; ``kwargs``: its fixed keyword
    arguments; ``flags``: the extra ``store_true`` flags the script parses;
    ``flag_kwargs``: the flags' keyword arguments it passes (False when
    absent); ``seed``: "or231" (``--seed`` default None, passed as ``seed
    or 231``), "231" (default 231) or "none" (default None, passed as
    is)."""

    fn: str
    kwargs: Dict[str, Any]
    seed: str = "none"
    flags: Tuple[str, ...] = ()
    flag_kwargs: Tuple[str, ...] = ()


def _task_scripts(task: str) -> Dict[str, Script]:
    """The scripts cls and seg share (``main/{cls,seg}``)."""
    t = dict(task=task)
    return {
        f"test_{task}": Script("task_eval", t, "or231"),
        "test_diffbir": Script("diffbir_eval", t, "231"),
        "test_edtr": Script("edtr_eval_task", t, "231"),
        "test_swinir": Script("swinir_eval", t, "231"),
        f"train_{task}": Script("task_train", dict(t, recipe="task")),
        "train_diffbir": Script("diffbir_train", t),
        "train_edtr": Script("edtr_train_task", t),
        "train_swinir-pre": Script("task_train", dict(t, recipe="swinir-pre")),
        "train_swinir-sr4ir": Script("task_train", dict(t, recipe="sr4ir")),
        "train_swinir": Script("task_train", dict(t, recipe="swinir")),
    }


_DET = dict(task="det")
SCRIPTS: Dict[str, Dict[str, Script]] = {
    "cls": _task_scripts("cls"),
    "seg": _task_scripts("seg"),
    "det": {
        "test_det": Script("edtr_eval", {}, "or231", ("--save-img",), ("save_img", "calc_fd")),
        "test_diffbir": Script("diffbir_eval", _DET, "231"),
        "test_edtr": Script("edtr_eval", {}, "or231", ("--save-img", "--calc-fd"),
                            ("save_img", "calc_fd")),
        "test_swinir": Script("swinir_eval", _DET, "231"),
        "train_det": Script("task_train", dict(_DET, recipe="task")),
        "train_diffbir": Script("diffbir_train", _DET),
        "train_edtr": Script("edtr_train", {}),
        "train_swinir-pre": Script("task_train", dict(_DET, recipe="swinir-pre")),
        "train_swinir-sr4ir": Script("task_train", dict(_DET, recipe="sr4ir")),
        "train_swinir": Script("task_train", dict(_DET, recipe="swinir")),
    },
}


def _usage() -> str:
    return ("usage: python -m edtr_torch.cli {cls,seg,det} <script> --config CONFIG [...]\n"
            + "\n".join(f"  {task}: {' '.join(sorted(scripts))}"
                        for task, scripts in SCRIPTS.items()))


def parse(argv: Sequence[str]) -> Tuple[Script, argparse.Namespace]:
    """(the script, its parsed arguments) of ``argv`` = ``[task, script,
    ...]``; an unknown task or script, or an argument the script does not
    take, exits 2."""
    if len(argv) < 2 or argv[0] not in SCRIPTS or argv[1] not in SCRIPTS[argv[0]]:
        print(_usage(), file=sys.stderr)
        raise SystemExit(2)
    task, name = argv[0], argv[1]
    script = SCRIPTS[task][name]
    p = argparse.ArgumentParser(prog=f"python -m edtr_torch.cli {task} {name}")
    p.add_argument("--config", required=True)
    p.add_argument("--debug", action="store_true")
    p.add_argument("--seed", type=int, default=231 if script.seed == "231" else None)
    for flag in script.flags:
        p.add_argument(flag, action="store_true")
    return script, p.parse_args(list(argv[2:]))


def main(argv: Optional[Sequence[str]] = None):
    """Run the script ``argv`` names (``sys.argv[1:]`` by default); returns
    what its runner function returns."""
    from edtr_torch.train import runner

    script, args = parse(sys.argv[1:] if argv is None else argv)
    seed = (args.seed or 231) if script.seed == "or231" else args.seed
    kwargs = dict(script.kwargs, debug=args.debug, seed=seed)
    for name in script.flag_kwargs:
        kwargs[name] = getattr(args, name, False)
    return getattr(runner, script.fn)(args.config, **kwargs)


if __name__ == "__main__":
    main()
