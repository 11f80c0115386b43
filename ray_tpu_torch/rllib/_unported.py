"""The one error the RLlib port raises for what is not ported yet."""


def unported(what: str, item: str = "A14e") -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to ray_tpu_torch yet (ROADMAP.md, Queue A "
        f"item {item})")
