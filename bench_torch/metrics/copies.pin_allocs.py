"""New page-locked host blocks the render's copies to the host allocated,
a render, over the window (`info["host_pin_allocs"]`, from torch's
caching host allocator; a render whose copies all found a cached block
adds 0). A program, or a torch, without the counter gives nothing."""


def read(run):
    infos = [r.info for r in run.records if r.info and "d2h_bytes" in r.info]
    if not any("host_pin_allocs" in i for i in infos):
        return None
    return sum(i.get("host_pin_allocs", 0) for i in infos) / len(infos)
