"""Items of one kind (a call's "proofs" or "blobs") completed in the
window, over the window's seconds: the calls that started in the window,
up to the end of the last of them."""


def read(ctx, items: str):
    done = sum(c.items.get(items, 0) for c in ctx.calls if c.error is None)
    return done / ctx.window_s if done and ctx.window_s > 0 else None
