"""Mean seconds a render of the library's way to the card (the
`prologue.library` span inside `render.prologue`, `render/matched.py`
`start_render`: the palettes' upload and `build_library`'s mirrors); a
program without the span gives nothing."""

from bench_torch.spans import per_render


def read(run):
    return per_render(run, "prologue.library")
