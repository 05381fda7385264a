"""New registrations of host memory a render's uploads made, a render,
over the window (`info["host_registers"]`, counted by
`ops/copies.py` `to_device_kept`; a render whose kept arrays were all
registered before adds 0). A program without the counter gives nothing."""


def read(run):
    infos = [r.info for r in run.records if r.info and "h2d_bytes" in r.info]
    if not any("host_registers" in i for i in infos):
        return None
    return sum(i.get("host_registers", 0) for i in infos) / len(infos)
