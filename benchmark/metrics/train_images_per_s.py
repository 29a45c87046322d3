"""train_images_per_s: samples of every pretraining step in the window,
over the window's time ended by a synchronize."""


def read(rec, mode):
    if rec["mode"] != "train":
        return None
    return rec["units"] / rec["window_s"]
